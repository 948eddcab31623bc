// A self-contained Zstandard codec (RFC 8878) for the JAX package's orbax
// checkpoints on machines without a zstd library: every array chunk and
// every OCDBT node of a checkpoint is a zstd frame.
//
// The decoder reads zstd frames (single-segment or windowed, with or without
// the content size), raw, RLE and compressed blocks, raw / RLE / Huffman (1
// or 4 streams) / treeless literals, predefined / RLE / FSE / repeat sequence
// tables with the three repeat offsets, skippable frames and any number of
// concatenated frames, and checks the XXH64 content checksum when a frame
// carries one. It refuses (a message and a nonzero return) dictionaries,
// reserved bits, and input that is cut short or corrupt; it never guesses.
//
// The encoder writes one frame that carries its content size, in blocks of
// at most 128 KiB, each the smallest of raw, RLE and compressed. A compressed
// block holds the sequences of a greedy hash match finder (4-byte matches
// within a 1 MiB window, the step growing over incompressible data), its
// literals Huffman-coded (1 or 4 streams, the weights FSE-coded where that
// is shorter than 4 bits a weight) and its sequence codes under the
// predefined tables or FSE tables built for the block, whichever is
// shorter. Any input is encoded; libzstd decodes the frames.
//
// Also computes CRC32C, the checksum of OCDBT's manifests and nodes.
//
// Every call owns its state, so callers may encode and decode in threads
// (ctypes releases the GIL around each call). Needs only a C++ compiler; C
// ABI, bound with ctypes (megapose6d_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Thrown when the output does not fit the caller's buffer (return code 2,
// so the caller can retry with a larger one).
struct TooSmall {};

[[noreturn]] void fail(const std::string& msg) { throw ZstdError(msg); }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr int kMaxHufBits = 11;

inline int highbit(uint64_t x) { return 63 - __builtin_clzll(x); }  // x > 0

inline uint32_t read_le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t read_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// ---------------------------------------------------------------------------
// Bit streams
// ---------------------------------------------------------------------------

// Bits [off, off + n) of `src` as a little-endian number (n <= 57); bits
// below 0 read as zeros (a backward stream's end).
inline uint64_t get_bits(const uint8_t* src, size_t len, int64_t off, int n) {
  if (n == 0) return 0;
  int shift = 0;
  if (off < 0) {
    shift = (int)-off;
    n -= shift;
    off = 0;
    if (n <= 0) return 0;
  }
  size_t b = (size_t)(off >> 3);
  uint64_t word;
  if (b + 8 <= len) {
    word = read_le64(src + b);
  } else {
    word = 0;
    for (size_t i = b; i < len; i++) word |= (uint64_t)src[i] << (8 * (i - b));
  }
  uint64_t v = (word >> (off & 7)) & ((1ull << n) - 1);
  return v << shift;
}

// A stream read backward from its end (FSE and Huffman bitstreams): the
// highest set bit of the last byte marks where the bits start.
struct BackStream {
  const uint8_t* src;
  size_t len;
  int64_t off;

  BackStream(const uint8_t* s, size_t n, const char* what) : src(s), len(n) {
    if (n == 0) fail(std::string("empty ") + what + " bitstream");
    if (s[n - 1] == 0) fail(std::string(what) + " bitstream has no end marker");
    off = (int64_t)n * 8 - (8 - highbit(s[n - 1]));
  }
  uint64_t read(int n) {
    off -= n;
    return get_bits(src, len, off, n);
  }
};

// A stream read forward, little-endian (FSE table descriptions).
struct ForwardBits {
  const uint8_t* src;
  size_t len;
  int64_t off = 0;
  uint64_t read(int n) {
    if (off + n > (int64_t)len * 8) fail("FSE table description cut short");
    uint64_t v = get_bits(src, len, off, n);
    off += n;
    return v;
  }
  size_t bytes_used() const { return (size_t)((off + 7) >> 3); }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct Fse {
  int log = 0;
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
  bool defined = false;

  // The spread of RFC 8878 4.1.1 from normalized counts (-1: "less than one").
  void build(const int16_t* norm, int nsym, int accuracy_log) {
    log = accuracy_log;
    const uint32_t size = 1u << log;
    sym.assign(size, 0);
    nbits.assign(size, 0);
    base.assign(size, 0);
    std::vector<uint16_t> next(nsym);
    uint32_t high = size;
    for (int s = 0; s < nsym; s++) {
      if (norm[s] == -1) {
        if (high == 0) fail("FSE table overfull");
        sym[--high] = (uint8_t)s;
        next[s] = 1;
      }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t pos = 0;
    for (int s = 0; s < nsym; s++) {
      if (norm[s] <= 0) continue;
      next[s] = (uint16_t)norm[s];
      for (int i = 0; i < norm[s]; i++) {
        sym[pos] = (uint8_t)s;
        do pos = (pos + step) & mask;
        while (pos >= high);
      }
    }
    if (pos != 0) fail("corrupt FSE table");
    for (uint32_t i = 0; i < size; i++) {
      uint16_t n = next[sym[i]]++;
      nbits[i] = (uint8_t)(log - highbit(n));
      base[i] = (uint16_t)(((uint32_t)n << nbits[i]) - size);
    }
    defined = true;
  }

  // One symbol (accuracy log 0): every state gives it, reading no bits.
  void rle(uint8_t s) {
    log = 0;
    sym.assign(1, s);
    nbits.assign(1, 0);
    base.assign(1, 0);
    defined = true;
  }

  // A table description (RFC 8878 4.1.1); returns the bytes it took.
  size_t read(const uint8_t* src, size_t len, int max_log, int max_sym) {
    ForwardBits in{src, len};
    const int accuracy_log = 5 + (int)in.read(4);
    if (accuracy_log > max_log) fail("FSE accuracy log too large");
    int32_t remaining = 1 << accuracy_log;
    int16_t norm[256];
    int nsym = 0;
    while (remaining > 0) {
      if (nsym > max_sym) fail("FSE table has too many symbols");
      const int bits = highbit((uint64_t)remaining + 1) + 1;
      uint32_t val = (uint32_t)in.read(bits);
      const uint32_t lower = (1u << (bits - 1)) - 1;
      const uint32_t threshold = (1u << bits) - 1 - ((uint32_t)remaining + 1);
      if ((val & lower) < threshold) {
        in.off -= 1;  // a small value: one bit fewer
        val &= lower;
      } else if (val > lower) {
        val -= threshold;
      }
      const int16_t proba = (int16_t)((int)val - 1);
      remaining -= proba < 0 ? -proba : proba;
      norm[nsym++] = proba;
      if (proba == 0) {
        int repeat = (int)in.read(2);
        while (true) {
          for (int i = 0; i < repeat; i++) {
            if (nsym > max_sym) fail("FSE table has too many symbols");
            norm[nsym++] = 0;
          }
          if (repeat != 3) break;
          repeat = (int)in.read(2);
        }
      }
    }
    if (remaining != 0 || nsym > max_sym + 1) fail("corrupt FSE table description");
    build(norm, nsym, accuracy_log);
    return in.bytes_used();
  }
};

struct FseState {
  const Fse* t;
  uint32_t state;
  void init(BackStream& in) { state = (uint32_t)in.read(t->log); }
  uint8_t peek() const { return t->sym[state]; }
  void update(BackStream& in) { state = t->base[state] + (uint32_t)in.read(t->nbits[state]); }
};

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> sym, nbits;
  bool defined = false;

  void build(const uint8_t* weights, int n) {  // n transmitted weights
    if (n + 1 > 256) fail("too many Huffman symbols");
    uint64_t sum = 0;
    for (int i = 0; i < n; i++) {
      if (weights[i] > kMaxHufBits) fail("Huffman weight too large");
      sum += weights[i] ? 1ull << (weights[i] - 1) : 0;
    }
    if (sum == 0) fail("Huffman weights all zero");
    const int mb = highbit(sum) + 1;
    const uint64_t left = (1ull << mb) - sum;
    if (left & (left - 1)) fail("corrupt Huffman weights");
    const int last_weight = highbit(left) + 1;
    uint8_t bits[256];
    for (int i = 0; i < n; i++) bits[i] = weights[i] ? (uint8_t)(mb + 1 - weights[i]) : 0;
    bits[n] = (uint8_t)(mb + 1 - last_weight);
    const int nsym = n + 1;
    max_bits = 0;
    uint32_t count[kMaxHufBits + 2] = {};
    for (int i = 0; i < nsym; i++) {
      if (bits[i] > kMaxHufBits) fail("Huffman code too long");
      if (bits[i] > max_bits) max_bits = bits[i];
      count[bits[i]]++;
    }
    const uint32_t size = 1u << max_bits;
    sym.assign(size, 0);
    nbits.assign(size, 0);
    uint32_t start[kMaxHufBits + 2];
    start[max_bits] = 0;
    for (int i = max_bits; i >= 1; i--) {
      start[i - 1] = start[i] + count[i] * (1u << (max_bits - i));
      if (start[i - 1] > size) fail("corrupt Huffman table");
      std::memset(&nbits[start[i]], i, start[i - 1] - start[i]);
    }
    if (start[0] != size) fail("corrupt Huffman table");
    for (int i = 0; i < nsym; i++) {
      if (!bits[i]) continue;
      const uint32_t code = start[bits[i]], run = 1u << (max_bits - bits[i]);
      std::memset(&sym[code], i, run);
      start[bits[i]] += run;
    }
    defined = true;
  }

  // The tree description (RFC 8878 4.2.1); returns the bytes it took.
  size_t read(const uint8_t* src, size_t len) {
    if (len < 1) fail("Huffman tree description cut short");
    const int header = src[0];
    uint8_t weights[256];
    int n = 0;
    if (header >= 128) {  // direct: 4 bits a weight
      n = header - 127;
      const size_t bytes = (size_t)(n + 1) / 2;
      if (1 + bytes > len) fail("Huffman weights cut short");
      for (int i = 0; i < n; i++) weights[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
      build(weights, n);
      return 1 + bytes;
    }
    if ((size_t)header + 1 > len) fail("Huffman weights cut short");
    if (header == 0) fail("empty Huffman weights");
    Fse fse;
    const size_t used = fse.read(src + 1, header, 6, 255);
    if (used >= (size_t)header) fail("Huffman weights have no bitstream");
    BackStream in(src + 1 + used, header - used, "Huffman weight");
    FseState s1{&fse, 0}, s2{&fse, 0};
    s1.init(in);
    s2.init(in);
    auto push = [&](uint8_t w) {
      if (n == 255) fail("too many Huffman weights");
      weights[n++] = w;
    };
    while (true) {  // two interleaved states until the stream runs out
      push(s1.peek());
      s1.update(in);
      if (in.off < 0) {
        push(s2.peek());
        break;
      }
      push(s2.peek());
      s2.update(in);
      if (in.off < 0) {
        push(s1.peek());
        break;
      }
    }
    build(weights, n);
    return 1 + header;
  }

  // Backward streams s of n[s] symbols each (RFC 8878 4.2.2). A symbol is
  // looked up by the stream's next max_bits bits (zeros past its start)
  // and takes nbits of them; each stream must end exactly with its last
  // symbol. While every stream has 57 bits left, each gives four symbols
  // from one 64-bit load, the streams in turn (they are independent).
  template <int S>
  void decode_streams(const uint8_t* const* src, const size_t* len, uint8_t* const* out, const size_t* n) const {
    const int mb = max_bits;
    int64_t pos[S];
    size_t i[S];
    for (int s = 0; s < S; s++) {
      pos[s] = BackStream(src[s], len[s], "Huffman").off;
      i[s] = 0;
    }
    while (true) {
      bool fast = true;
      for (int s = 0; s < S; s++) fast = fast && i[s] + 4 <= n[s] && pos[s] >= 57;
      if (!fast) break;
      for (int s = 0; s < S; s++) {
        const int64_t end = (pos[s] + 7) >> 3;
        uint64_t v = read_le64(src[s] + end - 8) << (8 * end - pos[s]);
        for (int k = 0; k < 4; k++) {
          const uint32_t idx = (uint32_t)(v >> (64 - mb));
          out[s][i[s]++] = sym[idx];
          v <<= nbits[idx];
          pos[s] -= nbits[idx];
        }
      }
    }
    for (int s = 0; s < S; s++) {
      for (; i[s] < n[s]; i[s]++) {
        const uint32_t idx = (uint32_t)get_bits(src[s], len[s], pos[s] - mb, mb);
        out[s][i[s]] = sym[idx];
        pos[s] -= nbits[idx];
      }
      if (pos[s] != 0) fail("Huffman stream not consumed exactly");
    }
  }
};

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,    18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,   17,   18,   19,    20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,   35,   37,   39,    41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---------------------------------------------------------------------------
// XXH64 and CRC32C
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full, P3 = 0x165667B19E3779F9ull,
                   P4 = 0x85EBCA77C2B2AE63ull, P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t h, uint64_t v) { return (h ^ xxh_round(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, read_le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t)read_le32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[i] = c;
    }
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable table;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Frames
// ---------------------------------------------------------------------------

struct Output {
  uint8_t* dst;
  size_t cap;
  size_t pos = 0;
  void need(size_t n) const {
    if (n > cap - pos) throw TooSmall{};
  }
};

struct Frame {
  Output& out;
  size_t start;  // the frame's first output byte
  Huffman huf;
  Fse ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;

  explicit Frame(Output& o) : out(o), start(o.pos) { lit.reserve(kBlockMax); }

  // Literals section; returns the bytes it took.
  size_t literals(const uint8_t* src, size_t len) {
    if (len < 1) fail("literals section cut short");
    const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
    if (type <= 1) {  // raw or RLE
      size_t hsize, size;
      if ((fmt & 1) == 0) {
        hsize = 1;
        size = src[0] >> 3;
      } else if (fmt == 1) {
        hsize = 2;
        if (len < 2) fail("literals header cut short");
        size = (src[0] >> 4) + ((size_t)src[1] << 4);
      } else {
        hsize = 3;
        if (len < 3) fail("literals header cut short");
        size = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
      }
      if (size > kBlockMax) fail("literals larger than a block");
      lit.resize(size);
      if (type == 0) {
        if (hsize + size > len) fail("raw literals cut short");
        if (size) std::memcpy(lit.data(), src + hsize, size);
        return hsize + size;
      }
      if (hsize + 1 > len) fail("RLE literals cut short");
      std::memset(lit.data(), src[hsize], size);
      return hsize + 1;
    }
    // Huffman-compressed (2) or treeless (3)
    size_t hsize, regen, csize;
    int streams = fmt == 0 ? 1 : 4;
    if (fmt <= 1) {
      if (len < 3) fail("literals header cut short");
      const uint32_t h = src[0] | (src[1] << 8) | (src[2] << 16);
      hsize = 3;
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (fmt == 2) {
      if (len < 4) fail("literals header cut short");
      const uint32_t h = read_le32(src);
      hsize = 4;
      regen = (h >> 4) & 0x3FFF;
      csize = (h >> 18) & 0x3FFF;
    } else {
      if (len < 5) fail("literals header cut short");
      const uint64_t h = read_le32(src) | ((uint64_t)src[4] << 32);
      hsize = 5;
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax) fail("literals larger than a block");
    if (hsize + csize > len) fail("compressed literals cut short");
    const uint8_t* p = src + hsize;
    size_t n = csize;
    if (type == 2) {
      const size_t used = huf.read(p, n);
      p += used;
      n -= used;
    } else if (!huf.defined) {
      fail("treeless literals without a previous Huffman table");
    }
    lit.resize(regen);
    if (streams == 1) {
      uint8_t* o = lit.data();
      huf.decode_streams<1>(&p, &n, &o, &regen);
    } else {
      if (n < 6) fail("Huffman jump table cut short");
      const size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
      if (6 + s1 + s2 + s3 > n) fail("corrupt Huffman jump table");
      const size_t q = (regen + 3) / 4;
      if (3 * q > regen) fail("corrupt literals size");
      const uint8_t* b = p + 6;
      const uint8_t* srcs[4] = {b, b + s1, b + s1 + s2, b + s1 + s2 + s3};
      const size_t lens[4] = {s1, s2, s3, n - 6 - s1 - s2 - s3};
      uint8_t* outs[4] = {lit.data(), lit.data() + q, lit.data() + 2 * q, lit.data() + 3 * q};
      const size_t counts[4] = {q, q, q, regen - 3 * q};
      huf.decode_streams<4>(srcs, lens, outs, counts);
    }
    return hsize + csize;
  }

  // One sequence table (mode 0-3); returns the bytes it took.
  size_t table(Fse& t, int mode, const uint8_t* src, size_t len, const int16_t* def, int ndef, int def_log,
               int max_log, int max_sym, const char* what) {
    switch (mode) {
      case 0:
        t.build(def, ndef, def_log);
        return 0;
      case 1:
        if (len < 1) fail(std::string(what) + " RLE symbol cut short");
        if (src[0] > max_sym) fail(std::string(what) + " RLE symbol out of range");
        t.rle(src[0]);
        return 1;
      case 2:
        return t.read(src, len, max_log, max_sym);
      default:
        if (!t.defined) fail(std::string(what) + " table repeated before one was defined");
        return 0;
    }
  }

  void copy_literals(const uint8_t* p, size_t n) {
    out.need(n);
    if (n) std::memcpy(out.dst + out.pos, p, n);
    out.pos += n;
  }

  void compressed_block(const uint8_t* src, size_t len) {
    const size_t block_start = out.pos;
    size_t used = literals(src, len);
    const uint8_t* p = src + used;
    size_t n = len - used;
    if (n < 1) fail("sequences section cut short");
    size_t nseq;
    if (p[0] < 128) {
      nseq = p[0];
      p += 1, n -= 1;
    } else if (p[0] < 255) {
      if (n < 2) fail("sequences header cut short");
      nseq = ((size_t)(p[0] - 128) << 8) + p[1];
      p += 2, n -= 2;
    } else {
      if (n < 3) fail("sequences header cut short");
      nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
      p += 3, n -= 3;
    }
    if (nseq == 0) {
      if (n != 0) fail("bytes after an empty sequences section");
      copy_literals(lit.data(), lit.size());
      return;
    }
    if (n < 1) fail("sequences header cut short");
    const int modes = *p++;
    n--;
    if (modes & 3) fail("reserved bits set in the sequence modes");
    size_t k = table(ll, modes >> 6, p, n, kLLDefault, 36, 6, 9, 35, "literal lengths");
    p += k, n -= k;
    k = table(of, (modes >> 4) & 3, p, n, kOFDefault, 29, 5, 8, 31, "offsets");
    p += k, n -= k;
    k = table(ml, (modes >> 2) & 3, p, n, kMLDefault, 53, 6, 9, 52, "match lengths");
    p += k, n -= k;

    BackStream in(p, n, "sequences");
    FseState sl{&ll, 0}, so{&of, 0}, sm{&ml, 0};
    sl.init(in);
    so.init(in);
    sm.init(in);
    const uint8_t* lp = lit.data();
    const uint8_t* lend = lit.data() + lit.size();
    for (size_t i = 0; i < nseq; i++) {
      const int ofc = so.peek(), llc = sl.peek(), mlc = sm.peek();
      if (ofc > 31) fail("offset code out of range");
      if (llc > 35 || mlc > 52) fail("length code out of range");
      const uint64_t ofv = (1ull << ofc) + in.read(ofc);
      const uint64_t mlen = kMLBase[mlc] + in.read(kMLBits[mlc]);
      const uint64_t llen = kLLBase[llc] + in.read(kLLBits[llc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const int idx = (int)ofv - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx < 3 ? rep[idx] : rep[0] - 1;
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (llen > (uint64_t)(lend - lp)) fail("literal length beyond the literals");
      copy_literals(lp, llen);
      lp += llen;
      if (offset == 0 || offset > out.pos - start) fail("match offset beyond the frame's output");
      if (out.pos - block_start + mlen > kBlockMax) fail("block larger than 128 KiB");
      out.need(mlen);
      uint8_t* d = out.dst + out.pos;
      const uint8_t* s = d - offset;
      if (offset >= mlen) {
        std::memcpy(d, s, mlen);
      } else {
        for (uint64_t j = 0; j < mlen; j++) d[j] = s[j];
      }
      out.pos += mlen;
      if (i + 1 < nseq) {
        sl.update(in);
        sm.update(in);
        so.update(in);
      }
    }
    if (in.off != 0) fail("sequences bitstream not consumed exactly");
    copy_literals(lp, lend - lp);
    if (out.pos - block_start > kBlockMax) fail("block larger than 128 KiB");
  }
};

struct FrameHeader {
  size_t size;  // header bytes, magic included
  bool has_fcs, checksum;
  uint64_t fcs;
};

FrameHeader frame_header(const uint8_t* src, size_t len) {
  if (len < 6) fail("frame header cut short");
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header");
  const size_t did_size = did_flag == 3 ? 4 : did_flag;
  const size_t fcs_size = fcs_flag == 0 ? single : (1u << fcs_flag);
  const size_t p = 5 + !single;  // the window descriptor: the whole output stays addressable
  if (p + did_size + fcs_size > len) fail("frame header cut short");
  uint64_t did = 0, fcs = 0;
  for (size_t i = 0; i < did_size; i++) did |= (uint64_t)src[p + i] << (8 * i);
  if (did != 0) fail("frame needs dictionary " + std::to_string(did) + ", and no dictionary is given");
  for (size_t i = 0; i < fcs_size; i++) fcs |= (uint64_t)src[p + did_size + i] << (8 * i);
  if (fcs_size == 2) fcs += 256;
  return {p + did_size + fcs_size, fcs_size > 0, ((fhd >> 2) & 1) != 0, fcs};
}

// One frame from src[0:len] (magic included); returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t len, Output& out) {
  const FrameHeader h = frame_header(src, len);
  size_t p = h.size;
  Frame f(out);
  while (true) {
    if (p + 3 > len) fail("block header cut short");
    const uint32_t bh = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16);
    p += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > kBlockMax) fail("block larger than 128 KiB");
    if (type == 0) {
      if (p + size > len) fail("raw block cut short");
      f.copy_literals(src + p, size);
      p += size;
    } else if (type == 1) {
      if (p + 1 > len) fail("RLE block cut short");
      out.need(size);
      std::memset(out.dst + out.pos, src[p], size);
      out.pos += size;
      p += 1;
    } else {
      if (p + size > len) fail("compressed block cut short");
      f.compressed_block(src + p, size);
      p += size;
    }
    if (last) break;
  }
  const size_t produced = out.pos - f.start;
  if (h.has_fcs && produced != h.fcs)
    fail("frame content size " + std::to_string(h.fcs) + " but " + std::to_string(produced) + " bytes decoded");
  if (h.checksum) {
    if (p + 4 > len) fail("content checksum cut short");
    if ((uint32_t)xxh64(out.dst + f.start, produced) != read_le32(src + p)) fail("content checksum mismatch");
    p += 4;
  }
  return p;
}

// Walks src's frames: `frame(offset)` decodes or measures the zstd frame
// at that offset and returns its length; skippable frames are skipped.
template <class F>
void for_each_frame(const uint8_t* src, size_t len, F frame) {
  if (len == 0) fail("no zstd frame");
  size_t p = 0;
  while (p < len) {
    if (len - p < 4) fail("frame magic cut short");
    const uint32_t magic = read_le32(src + p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (len - p < 8) fail("skippable frame header cut short");
      const uint64_t size = read_le32(src + p + 4);
      if (size > len - p - 8) fail("skippable frame cut short");
      p += 8 + size;
    } else if (magic == kMagic) {
      p += frame(p);
    } else {
      fail("not a zstd frame");
    }
  }
}

// A frame's length from its block headers, without decoding it.
size_t frame_length(const uint8_t* src, size_t len, const FrameHeader& h) {
  size_t p = h.size;
  while (true) {
    if (p + 3 > len) fail("block header cut short");
    const uint32_t bh = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16);
    p += 3 + (((bh >> 1) & 3) == 1 ? 1 : bh >> 3);
    if (p > len) fail("block cut short");
    if (bh & 1) break;
  }
  return p + (h.checksum ? 4 : 0);
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

constexpr int kWindowLog = 20;  // matches reach back at most 1 MiB
constexpr int kHashLog = 17;
constexpr size_t kNoPos = SIZE_MAX;

// Bits written forward, least significant first: an FSE table description
// as it is, and, closed by a 1 bit, a backward stream (Huffman literals,
// FSE weights, sequences), which the decoder reads from its end.
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void add(uint64_t v, int bits) {  // bits <= 32
    acc |= (v & ((1ull << bits) - 1)) << n;
    n += bits;
    while (n >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      n -= 8;
    }
  }
  void pad() {
    if (n) out.push_back((uint8_t)acc);
    acc = 0;
    n = 0;
  }
  void close() {
    add(1, 1);
    pad();
  }
};

// The accuracy log libzstd's FSE_optimalTableLog picks for `total` symbols
// up to `max_symbol`, within [5, max_log].
int table_log(uint64_t total, int max_symbol, int max_log) {
  int log = max_log;
  const int from_src = total > 1 ? highbit(total - 1) - 2 : 0;
  if (from_src < log) log = from_src;
  const int min_bits = std::min(highbit(total) + 1, highbit((uint64_t)max_symbol + 1) + 2);
  if (min_bits > log) log = min_bits;
  return std::max(5, std::min(log, max_log));
}

// Counts scaled to sum to 2^log, at least 1 for every symbol that occurs;
// the rounding is taken from, or given to, the largest.
std::vector<int16_t> normalize(const uint32_t* count, int nsym, uint64_t total, int log) {
  const int size = 1 << log;
  std::vector<int16_t> norm(nsym, 0);
  int sum = 0, largest = 0;
  for (int s = 0; s < nsym; s++) {
    if (!count[s]) continue;
    norm[s] = (int16_t)std::max<uint64_t>(1, (count[s] * (uint64_t)size + total / 2) / total);
    sum += norm[s];
    if (count[s] > count[largest]) largest = s;
  }
  while (sum > size) {
    int best = largest;
    for (int s = 0; s < nsym; s++)
      if (norm[s] > norm[best]) best = s;
    const int take = std::min(sum - size, norm[best] - 1);
    norm[best] = (int16_t)(norm[best] - take);
    sum -= take;
  }
  norm[largest] = (int16_t)(norm[largest] + size - sum);
  return norm;
}

// Bits that `count` costs under a table of normalized counts (-1 costs as
// 1); infinity when a symbol that occurs has none.
double table_cost(const uint32_t* count, int nsym, const int16_t* norm, int nnorm, int log) {
  double bits = 0;
  for (int s = 0; s < nsym; s++) {
    if (!count[s]) continue;
    if (s >= nnorm || norm[s] == 0) return 1e300;
    bits += count[s] * (log - std::log2((double)std::max<int16_t>(norm[s], 1)));
  }
  return bits;
}

// The table description of RFC 8878 4.1.1: the inverse of Fse::read.
void write_ncount(std::vector<uint8_t>& out, const std::vector<int16_t>& norm, int log) {
  int nsym = (int)norm.size();
  while (nsym > 0 && norm[nsym - 1] == 0) nsym--;
  BitWriter w(out);
  w.add(log - 5, 4);
  int remaining = 1 << log;
  for (int s = 0; s < nsym && remaining > 0;) {
    const uint32_t v = (uint32_t)(norm[s] + 1);
    const int bits = highbit((uint64_t)remaining + 1) + 1;
    const uint32_t lower = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - ((uint32_t)remaining + 1);
    if (v < threshold)
      w.add(v, bits - 1);
    else if (v <= lower)
      w.add(v, bits);
    else
      w.add(v + threshold, bits);
    remaining -= norm[s] < 0 ? -norm[s] : norm[s];
    if (norm[s++] == 0) {
      int run = 0;
      while (s + run < nsym && norm[s + run] == 0) run++;
      s += run;
      for (; run >= 3; run -= 3) w.add(3, 2);
      w.add(run, 2);
    }
  }
  w.pad();
}

// FSE compression tables (libzstd's FSE_buildCTable), the mirror of
// Fse::build's spread.
struct FseEnc {
  int log = 0;
  std::vector<uint16_t> next_state;
  std::vector<int32_t> find;
  std::vector<uint32_t> delta_bits;

  void build(const int16_t* norm, int nsym, int accuracy_log) {
    log = accuracy_log;
    const uint32_t size = 1u << log, mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
    std::vector<uint8_t> symbol(size);
    std::vector<uint32_t> cumul(nsym + 1, 0);
    uint32_t high = size - 1;
    for (int s = 0; s < nsym; s++) {
      if (norm[s] == -1) {
        cumul[s + 1] = cumul[s] + 1;
        symbol[high--] = (uint8_t)s;
      } else {
        cumul[s + 1] = cumul[s] + (uint32_t)std::max<int16_t>(norm[s], 0);
      }
    }
    uint32_t pos = 0;
    for (int s = 0; s < nsym; s++) {
      for (int i = 0; i < norm[s]; i++) {
        symbol[pos] = (uint8_t)s;
        do pos = (pos + step) & mask;
        while (pos > high);
      }
    }
    next_state.assign(size, 0);
    for (uint32_t u = 0; u < size; u++) next_state[cumul[symbol[u]]++] = (uint16_t)(size + u);
    find.assign(nsym, 0);
    delta_bits.assign(nsym, 0);
    int32_t total = 0;
    for (int s = 0; s < nsym; s++) {
      if (norm[s] == 0) {
        delta_bits[s] = ((uint32_t)(log + 1) << 16) - size;
      } else if (norm[s] == -1 || norm[s] == 1) {
        delta_bits[s] = ((uint32_t)log << 16) - size;
        find[s] = total - 1;
        total++;
      } else {
        const uint32_t max_out = (uint32_t)(log - highbit((uint64_t)norm[s] - 1));
        delta_bits[s] = (max_out << 16) - ((uint32_t)norm[s] << max_out);
        find[s] = total - norm[s];
        total += norm[s];
      }
    }
  }
};

struct FseEncState {
  const FseEnc* t;
  uint32_t value = 0;
  // The first symbol's state: the one that reads the most bits back, so
  // that a decoder which stops on overrun stops there.
  void init(int s) {
    const uint32_t nb = (t->delta_bits[s] + (1u << 15)) >> 16;
    const uint32_t v = (nb << 16) - t->delta_bits[s];
    value = t->next_state[(v >> nb) + t->find[s]];
  }
  void encode(BitWriter& w, int s) {
    const uint32_t nb = (value + t->delta_bits[s]) >> 16;
    w.add(value, (int)nb);
    value = t->next_state[(value >> nb) + t->find[s]];
  }
  void flush(BitWriter& w) const { w.add(value, t->log); }
};

// Huffman-coded literals.
struct HufEnc {
  uint8_t len[256] = {};
  uint32_t code[256] = {};
  int max_bits = 0, last = 0;  // last: the largest symbol with a code

  // Code lengths of at most 11 bits from the counts (two or more symbols
  // occur): Huffman's, then the longest ones folded up as JPEG's Annex K.3
  // does, and handed out by frequency.
  void build(const uint32_t* count) {
    std::vector<uint64_t> weight;
    std::vector<int> parent, syms;
    for (int s = 0; s < 256; s++) {
      if (!count[s]) continue;
      syms.push_back(s);
      weight.push_back(count[s]);
      parent.push_back(-1);
    }
    using Item = std::pair<uint64_t, int>;
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
    for (size_t i = 0; i < weight.size(); i++) heap.push({weight[i], (int)i});
    while (heap.size() > 1) {
      const Item a = heap.top();
      heap.pop();
      const Item b = heap.top();
      heap.pop();
      const int id = (int)weight.size();
      weight.push_back(a.first + b.first);
      parent.push_back(-1);
      parent[a.second] = parent[b.second] = id;
      heap.push({weight.back(), id});
    }
    std::vector<int> bits(512, 0);
    int longest = 0;
    for (size_t i = 0; i < syms.size(); i++) {
      int depth = 0;
      for (int p = (int)i; parent[p] >= 0; p = parent[p]) depth++;
      bits[depth]++;
      longest = std::max(longest, depth);
    }
    for (int i = longest; i > kMaxHufBits; i--) {
      while (bits[i] > 0) {
        int j = i - 2;
        while (bits[j] == 0) j--;
        bits[i] -= 2;
        bits[i - 1] += 1;
        bits[j + 1] += 2;
        bits[j] -= 1;
      }
    }
    std::vector<int> order(syms);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) { return count[a] > count[b]; });
    size_t k = 0;
    for (int l = 1; l <= kMaxHufBits; l++)
      for (int i = 0; i < bits[l]; i++) len[order[k++]] = (uint8_t)l;
    max_bits = 0;
    for (int s = 0; s < 256; s++)
      if (len[s]) {
        max_bits = std::max<int>(max_bits, len[s]);
        last = s;
      }
    // Codes as Huffman::build lays out its table: the longest codes first,
    // each length in symbol order.
    uint32_t start[kMaxHufBits + 2] = {};
    for (int i = max_bits; i >= 1; i--) start[i - 1] = start[i] + (uint32_t)bits[i] * (1u << (max_bits - i));
    for (int s = 0; s < 256; s++) {
      if (!len[s]) continue;
      code[s] = start[len[s]] >> (max_bits - len[s]);
      start[len[s]] += 1u << (max_bits - len[s]);
    }
  }

  // The tree description (RFC 8878 4.2.1): the weights of symbols
  // 0..last-1, FSE-coded or 4 bits each, whichever is shorter. False when
  // neither fits (over 128 weights, none FSE-codable under 128 bytes).
  bool describe(std::vector<uint8_t>& out) const {
    const int n = last;
    uint8_t w[256];
    uint32_t count[kMaxHufBits + 1] = {};
    int max_w = 0;
    for (int s = 0; s < n; s++) {
      w[s] = len[s] ? (uint8_t)(max_bits + 1 - len[s]) : 0;
      count[w[s]]++;
      max_w = std::max<int>(max_w, w[s]);
    }
    std::vector<uint8_t> fse;
    int distinct = 0;
    for (int v = 0; v <= max_w; v++) distinct += count[v] > 0;
    if (n >= 2 && distinct >= 2) {
      const int log = table_log(n, max_w, 6);
      const std::vector<int16_t> norm = normalize(count, max_w + 1, n, log);
      FseEnc t;
      t.build(norm.data(), max_w + 1, log);
      write_ncount(fse, norm, log);
      BitWriter bw(fse);
      FseEncState s1{&t}, s2{&t};
      int i = n;
      if (n & 1) {
        s1.init(w[--i]);
        s2.init(w[--i]);
        s1.encode(bw, w[--i]);
      } else {
        s2.init(w[--i]);
        s1.init(w[--i]);
      }
      while (i > 0) {
        s2.encode(bw, w[--i]);
        s1.encode(bw, w[--i]);
      }
      s2.flush(bw);
      s1.flush(bw);
      bw.close();
    }
    const bool fse_ok = !fse.empty() && fse.size() < 128;
    const size_t direct = n <= 128 ? 1 + (size_t)(n + 1) / 2 : SIZE_MAX;
    if (fse_ok && 1 + fse.size() <= direct) {
      out.push_back((uint8_t)fse.size());
      out.insert(out.end(), fse.begin(), fse.end());
      return true;
    }
    if (direct == SIZE_MAX) return false;
    out.push_back((uint8_t)(127 + n));
    for (int i = 0; i < n; i += 2) out.push_back((uint8_t)(w[i] << 4 | (i + 1 < n ? w[i + 1] : 0)));
    return true;
  }

  // One backward stream: the literals from the last to the first.
  void stream(const uint8_t* lit, size_t n, std::vector<uint8_t>& out) const {
    BitWriter w(out);
    for (size_t i = n; i-- > 0;) w.add(code[lit[i]], len[lit[i]]);
    w.close();
  }
};

void put_le(std::vector<uint8_t>& out, uint64_t v, int bytes) {
  for (int i = 0; i < bytes; i++) out.push_back((uint8_t)(v >> (8 * i)));
}

// A raw or RLE literals header (type 0 or 1).
void plain_literals_header(std::vector<uint8_t>& out, int type, size_t n) {
  if (n <= 31)
    put_le(out, type | n << 3, 1);
  else if (n <= 4095)
    put_le(out, type | 1 << 2 | n << 4, 2);
  else
    put_le(out, type | 3 << 2 | n << 4, 3);
}

// The literals section: raw, RLE or Huffman-coded, whichever is shortest.
void encode_literals(const uint8_t* lit, size_t n, std::vector<uint8_t>& out) {
  uint32_t count[256] = {};
  for (size_t i = 0; i < n; i++) count[lit[i]]++;
  int distinct = 0;
  for (int s = 0; s < 256; s++) distinct += count[s] > 0;
  if (n > 0 && distinct == 1) {
    plain_literals_header(out, 1, n);
    out.push_back(lit[0]);
    return;
  }
  const size_t raw = (n <= 31 ? 1 : n <= 4095 ? 2 : 3) + n;
  if (n >= 32) {
    HufEnc h;
    h.build(count);
    std::vector<uint8_t> body;
    if (h.describe(body)) {
      const size_t tree = body.size();
      bool single = n <= 1023;
      if (single) {
        h.stream(lit, n, body);
        single = body.size() <= 1023;
        if (!single) body.resize(tree);
      }
      if (!single) {
        const size_t q = (n + 3) / 4;
        body.resize(tree + 6);
        size_t sizes[4];
        for (int s = 0; s < 4; s++) {
          const size_t before = body.size(), from = s * q, to = s < 3 ? from + q : n;
          h.stream(lit + from, to - from, body);
          sizes[s] = body.size() - before;
        }
        for (int s = 0; s < 3; s++) {  // 32 Ki literals of 11 bits at most: under 64 KiB
          body[tree + 2 * s] = (uint8_t)sizes[s];
          body[tree + 2 * s + 1] = (uint8_t)(sizes[s] >> 8);
        }
      }
      const size_t c = body.size(), big = std::max(n, c);
      const int fmt = single ? 0 : big <= 1023 ? 1 : big <= 16383 ? 2 : 3;
      const size_t hsize = fmt <= 1 ? 3 : fmt == 2 ? 4 : 5;
      if (hsize + c < raw) {
        const int shift = fmt <= 1 ? 14 : fmt == 2 ? 18 : 22;
        put_le(out, 2 | (uint64_t)fmt << 2 | (uint64_t)n << 4 | (uint64_t)c << shift, (int)hsize);
        out.insert(out.end(), body.begin(), body.end());
        return;
      }
    }
  }
  plain_literals_header(out, 0, n);
  out.insert(out.end(), lit, lit + n);
}

struct Seq {
  uint32_t lit_len, match_len, offset;
};

int ll_code(uint32_t v) {
  if (v >= 64) return highbit(v) + 19;
  int c = 35;
  while (kLLBase[c] > v) c--;
  return c;
}

int ml_code(uint32_t match_len) {
  const uint32_t v = match_len - 3;
  if (v >= 128) return highbit(v) + 36;
  int c = 52;
  while (kMLBase[c] > match_len) c--;
  return c;
}

// One of the three sequence tables: its mode (0 predefined, 1 RLE, 2 FSE)
// and encoding tables, with the description it writes.
struct SeqTable {
  int mode = 0;
  FseEnc t;
  std::vector<uint8_t> desc;

  void choose(const uint32_t* count, int nsym, uint64_t total, const int16_t* def, int ndef, int def_log,
              int max_log) {
    int used = 0, max_s = 0, only = 0;
    for (int s = 0; s < nsym; s++)
      if (count[s]) {
        used++;
        max_s = s;
        only = s;
      }
    if (used == 1) {
      mode = 1;
      desc.assign(1, (uint8_t)only);
      return;
    }
    const int log = table_log(total, max_s, max_log);
    const std::vector<int16_t> norm = normalize(count, max_s + 1, total, log);
    std::vector<uint8_t> header;
    write_ncount(header, norm, log);
    const double fse = table_cost(count, nsym, norm.data(), max_s + 1, log) + 8.0 * header.size();
    if (table_cost(count, nsym, def, ndef, def_log) <= fse) {
      mode = 0;
      t.build(def, ndef, def_log);
    } else {
      mode = 2;
      t.build(norm.data(), max_s + 1, log);
      desc = header;
    }
  }
};

struct Coded {
  uint8_t ll, ml, of;
};

// The sequences section (RFC 8878 3.1.1.3.2), written in libzstd's order:
// from the last sequence to the first, so that the decoder meets them first
// to last.
void encode_sequences(const std::vector<Seq>& seqs, std::vector<uint8_t>& out) {
  const size_t n = seqs.size();
  if (n < 128) {
    out.push_back((uint8_t)n);
  } else if (n < 0x7F00) {
    out.push_back((uint8_t)((n >> 8) + 128));
    out.push_back((uint8_t)n);
  } else {
    out.push_back(255);
    put_le(out, n - 0x7F00, 2);
  }
  if (n == 0) return;
  std::vector<Coded> codes(n);
  uint32_t cll[36] = {}, cml[53] = {}, cof[32] = {};
  for (size_t i = 0; i < n; i++) {
    codes[i] = {(uint8_t)ll_code(seqs[i].lit_len), (uint8_t)ml_code(seqs[i].match_len),
                (uint8_t)highbit((uint64_t)seqs[i].offset + 3)};
    cll[codes[i].ll]++;
    cml[codes[i].ml]++;
    cof[codes[i].of]++;
  }
  SeqTable ll, of, ml;
  ll.choose(cll, 36, n, kLLDefault, 36, 6, 9);
  of.choose(cof, 32, n, kOFDefault, 29, 5, 8);
  ml.choose(cml, 53, n, kMLDefault, 53, 6, 9);
  out.push_back((uint8_t)(ll.mode << 6 | of.mode << 4 | ml.mode << 2));
  for (const SeqTable* t : {&ll, &of, &ml}) out.insert(out.end(), t->desc.begin(), t->desc.end());

  BitWriter w(out);
  FseEncState sll{&ll.t}, sof{&of.t}, sml{&ml.t};
  auto extras = [&](size_t i) {
    const Seq& q = seqs[i];
    const Coded& c = codes[i];
    w.add(q.lit_len - kLLBase[c.ll], kLLBits[c.ll]);
    w.add(q.match_len - kMLBase[c.ml], kMLBits[c.ml]);
    w.add((uint64_t)q.offset + 3 - (1ull << c.of), c.of);
  };
  const Coded& lastc = codes[n - 1];
  if (ml.mode != 1) sml.init(lastc.ml);
  if (of.mode != 1) sof.init(lastc.of);
  if (ll.mode != 1) sll.init(lastc.ll);
  extras(n - 1);
  for (size_t i = n - 1; i-- > 0;) {
    if (of.mode != 1) sof.encode(w, codes[i].of);
    if (ml.mode != 1) sml.encode(w, codes[i].ml);
    if (ll.mode != 1) sll.encode(w, codes[i].ll);
    extras(i);
  }
  if (ml.mode != 1) sml.flush(w);
  if (of.mode != 1) sof.flush(w);
  if (ll.mode != 1) sll.flush(w);
  w.close();
}

inline uint32_t hash4(const uint8_t* p) { return (read_le32(p) * 2654435761u) >> (32 - kHashLog); }

// Greedy matches in src[bs, be) (positions are the frame's), 4 bytes or
// longer, within the window; the bytes between them are the literals.
void find_sequences(const uint8_t* src, size_t bs, size_t be, std::vector<size_t>& table, std::vector<Seq>& seqs,
                    std::vector<uint8_t>& lits) {
  size_t anchor = bs, ip = bs;
  while (ip + 4 <= be) {
    const uint32_t h = hash4(src + ip);
    const size_t cand = table[h];
    table[h] = ip;
    if (cand != kNoPos && ip - cand <= (1u << kWindowLog) && read_le32(src + cand) == read_le32(src + ip)) {
      size_t m = cand, p = ip, len = 4;
      while (p + len < be && src[m + len] == src[p + len]) len++;
      while (p > anchor && m > 0 && src[p - 1] == src[m - 1]) p--, m--, len++;
      lits.insert(lits.end(), src + anchor, src + p);
      seqs.push_back({(uint32_t)(p - anchor), (uint32_t)len, (uint32_t)(p - m)});
      ip = anchor = p + len;
      if (ip + 2 <= be && ip >= bs + 2) table[hash4(src + ip - 2)] = ip - 2;
      continue;
    }
    ip += 1 + ((ip - anchor) >> 8);
  }
  lits.insert(lits.end(), src + anchor, src + be);
}

void block_header(std::vector<uint8_t>& out, bool last, int type, size_t size) {
  put_le(out, (last ? 1 : 0) | type << 1 | size << 3, 3);
}

// One frame of all of src: its content size declared, single-segment up to
// the window, blocks of at most 128 KiB.
void encode_frame(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  put_le(out, kMagic, 4);
  const bool single = n <= (1u << kWindowLog);
  const int fcs_flag = n < 256 && single ? 0 : n < 65536 + 256 ? 1 : n <= 0xFFFFFFFFull ? 2 : 3;
  out.push_back((uint8_t)(fcs_flag << 6 | (single ? 1 : 0) << 5));
  if (!single) out.push_back((uint8_t)((kWindowLog - 10) << 3));
  if (fcs_flag == 0)
    put_le(out, n, 1);
  else if (fcs_flag == 1)
    put_le(out, n - 256, 2);
  else
    put_le(out, n, fcs_flag == 2 ? 4 : 8);
  if (n == 0) {
    block_header(out, true, 0, 0);
    return;
  }
  std::vector<size_t> table(1u << kHashLog, kNoPos);
  std::vector<Seq> seqs;
  std::vector<uint8_t> lits, body;
  for (size_t bs = 0; bs < n; bs += kBlockMax) {
    const size_t be = std::min(n, bs + kBlockMax), size = be - bs;
    const bool last = be == n;
    size_t same = 1;
    while (same < size && src[bs + same] == src[bs]) same++;
    if (same == size && size > 1) {
      block_header(out, last, 1, size);
      out.push_back(src[bs]);
      continue;
    }
    seqs.clear();
    lits.clear();
    body.clear();
    find_sequences(src, bs, be, table, seqs, lits);
    encode_literals(lits.data(), lits.size(), body);
    encode_sequences(seqs, body);
    if (body.size() < size) {
      block_header(out, last, 2, body.size());
      out.insert(out.end(), body.begin(), body.end());
    } else {
      block_header(out, last, 0, size);
      out.insert(out.end(), src + bs, src + be);
    }
  }
}

void put_message(char* msg, int cap, const char* text) {
  if (msg && cap > 0) {
    std::strncpy(msg, text, (size_t)cap - 1);
    msg[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// The sum of the frames' declared content sizes, or -1 when a frame does
// not declare its size (the caller then grows its buffer). Returns -2 with
// a message when the frame headers are malformed; the full check is the
// decode's.
long mp_zstd_content_size(const unsigned char* src, long len, char* msg, int msg_cap) {
  try {
    long total = 0;
    for_each_frame(src, (size_t)len, [&](size_t p) {
      const FrameHeader h = frame_header(src + p, (size_t)len - p);
      total = (total < 0 || !h.has_fcs) ? -1 : total + (long)h.fcs;
      return frame_length(src + p, (size_t)len - p, h);
    });
    return total;
  } catch (const std::exception& e) {
    put_message(msg, msg_cap, e.what());
    return -2;
  }
}

// Decodes every frame of src into dst (cap bytes). Returns 0 with the
// decoded length in *out_len, 2 when dst is too small, or 1 with a message.
int mp_zstd_decode(const unsigned char* src, long len, unsigned char* dst, long cap, long* out_len, char* msg,
                   int msg_cap) {
  try {
    Output out{dst, (size_t)cap};
    for_each_frame(src, (size_t)len, [&](size_t p) { return decode_frame(src + p, (size_t)len - p, out); });
    *out_len = (long)out.pos;
    return 0;
  } catch (const TooSmall&) {
    return 2;
  } catch (const std::exception& e) {
    put_message(msg, msg_cap, e.what());
    return 1;
  }
}

// The most bytes mp_zstd_encode writes for `len` bytes of input.
long mp_zstd_encode_bound(long len) { return len + 3 * (len / (long)kBlockMax + 1) + 32; }

// Encodes src as one zstd frame into dst (cap bytes, at least the bound).
// Returns the frame's length, or -1 with a message.
long mp_zstd_encode(const unsigned char* src, long len, unsigned char* dst, long cap, char* msg, int msg_cap) {
  try {
    std::vector<uint8_t> out;
    out.reserve((size_t)len / 2 + 64);
    encode_frame(src, (size_t)len, out);
    if ((long)out.size() > cap) fail("zstd frame larger than the buffer");
    std::memcpy(dst, out.data(), out.size());
    return (long)out.size();
  } catch (const std::exception& e) {
    put_message(msg, msg_cap, e.what());
    return -1;
  }
}

unsigned int mp_crc32c(const unsigned char* src, long len) { return crc32c(src, (size_t)len); }

}  // extern "C"
