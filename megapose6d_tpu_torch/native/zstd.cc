// A self-contained Zstandard decoder (RFC 8878) for reading the JAX
// package's orbax checkpoints on machines without a zstd library: every
// array chunk and every OCDBT node of a checkpoint is a zstd frame.
//
// Decodes zstd frames (single-segment or windowed, with or without the
// content size), raw, RLE and compressed blocks, raw / RLE / Huffman (1 or
// 4 streams) / treeless literals, predefined / RLE / FSE / repeat sequence
// tables with the three repeat offsets, skippable frames and any number of
// concatenated frames, and checks the XXH64 content checksum when a frame
// carries one. Refuses (a message and a nonzero return) dictionaries,
// reserved bits, and input that is cut short or corrupt; it never guesses.
// Also computes CRC32C, the checksum of OCDBT's manifests and nodes.
//
// Every call owns its state, so callers may decode in threads. Needs only a
// C++ compiler; C ABI, bound with ctypes
// (megapose6d_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
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

unsigned int mp_crc32c(const unsigned char* src, long len) { return crc32c(src, (size_t)len); }

}  // extern "C"
