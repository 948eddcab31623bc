// A self-contained JPEG decoder for the PyTorch package's input pipeline,
// for machines without libjpeg's headers. Its output is bit for bit what
// libjpeg-turbo gives with its default settings (the route of decode.cc and
// of PIL): the integer IDCT of jidctint.c (jpeg_idct_islow), the "fancy"
// upsampling of jdsample.c, the fixed-point YCbCr -> RGB tables of
// jdcolor.c, and the colour space rules of jdapimin.c.
//
// Decodes baseline, extended sequential and progressive JPEGs with 8-bit
// samples, Huffman or arithmetic coded (jdhuff.c, jdphuff.c, jdarith.c),
// 1 component (grey -> [H, W]) or 3 (-> [H, W, 3] RGB), with any integral
// sampling factors, restart intervals, stuffed bytes and fill bytes.
// Refuses (a message and a nonzero return) 12-bit samples, lossless and
// hierarchical files, other component counts, and truncated or corrupt
// entropy data. libjpeg fills such data with grey after a warning and
// smooths the blocks of a progressive file whose scans stop early; this
// decoder never guesses.
//
// The whole image's coefficients are decoded first (one array per
// component), then each block is transformed, each component upsampled and
// the colours converted. Every call owns its state, so a batch decodes in
// threads that share nothing. Needs only a C++ compiler; C ABI, bound with
// ctypes (megapose6d_tpu_torch/native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// Zigzag index -> natural index, with 16 extra entries of 63 so that
// corrupt run lengths stay in the block (as jutils.c's table).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[17] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value, 0 = longer code

  // jdhuff.c jpeg_make_d_derived_tbl, with its checks.
  void derive(bool is_dc) {
    int huffsize[257], p = 0;
    for (int l = 1; l <= 16; l++) {
      if (p + bits[l] > 256) fail("bad Huffman table");
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int numsymbols = p;
    unsigned int huffcode[257];
    unsigned int code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1u << si)) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - (int)huffcode[p];
        p += bits[l];
        maxcode[l] = (int32_t)huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int lookbits = (int)huffcode[p] << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--) look[lookbits++] = (uint16_t)((l << 8) | vals[p]);
      }
    }
    if (is_dc)
      for (int i = 0; i < numsymbols; i++)
        if (vals[i] > 15) fail("bad Huffman table");
  }
};

// The entropy-coded bytes of one scan: 0xFF00 is a 0xFF byte, a marker
// ends the data. Past the end the reader gives zero bits (as libjpeg does
// for its look-ahead), and reading any of them is an error.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0, pad = 0;
  bool ended = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      unsigned b = 0;
      if (ended || pos >= n) {
        ended = true;
        pad += 8;
      } else if (d[pos] != 0xFF) {
        b = d[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] == 0) {
          b = 0xFF;
          pos = q + 1;
        } else {
          ended = true;  // a marker: pos stays on its first 0xFF
          pad += 8;
        }
      }
      buf |= (uint64_t)b << (56 - cnt);
      cnt += 8;
    }
  }
  void consumed(int k) {
    buf <<= k;
    cnt -= k;
    if (cnt < pad) fail("premature end of JPEG data (truncated or corrupt file)");
  }
  int get(int k) {  // 1 <= k <= 16
    if (cnt < k) fill();
    int v = (int)(buf >> (64 - k));
    consumed(k);
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    int e = h.look[buf >> (64 - kLookBits)];
    if (e) {
      consumed(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int code = (int)(buf >> (64 - l));
    while (code > h.maxcode[l]) {
      if (++l > 16) fail("corrupt JPEG data: bad Huffman code");
      code = (int)(buf >> (64 - l));
    }
    consumed(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled_width / _height
  int bw = 0, bh = 0;        // width_in_blocks / height_in_blocks
  int stride = 0, rows = 0;  // blocks allocated per row / rows (MCU padding)
  bool latched = false;
  int16_t qt[64] = {};  // natural order
  std::vector<int16_t> coef;
  int coef_bits[64];
  int scans = 0;
  int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * stride + bx) * 64; }
};

struct Scan {
  int ns;
  Component* sc[4];
  int td[4], ta[4];
  int ss, se, ah, al;
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  uint16_t qt[4][64] = {};
  bool qdef[4] = {};
  Huffman dc[4], ac[4];
  // Arithmetic conditioning (DAC), libjpeg's defaults.
  uint8_t dac_l[16] = {}, dac_u[16] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
          dac_k[16] = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
  int restart = 0;
  bool frame = false, progressive = false, arith = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("premature end of JPEG data (truncated file)");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }
  // jdmarker.c next_marker: skips bytes until 0xFF, then fill bytes.
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) return -1;
      int m = d[pos++];
      if (m != 0) return m;
    }
  }

  void read_header_until_frame_or_end(bool stop_at_frame) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0) {
        if (!frame) fail("premature end of JPEG data: no frame header");
        if (stop_at_frame) return;
        finish_check();
        return;  // no EOI: libjpeg inserts one, so do we
      }
      if (m == 0xD9) {  // EOI
        if (!frame) fail("JPEG file without a frame");
        if (stop_at_frame) return;
        finish_check();
        return;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn: no parameters
      if (m == 0xD8) fail("corrupt JPEG data: SOI inside the file");
      size_t start = pos;
      int len = u16();
      if (len < 2 || start + len > n) fail("corrupt JPEG data: bad marker length");
      size_t end = start + len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC9: case 0xCA:
          read_frame(m, end);
          if (stop_at_frame) return;
          break;
        case 0xC3: fail("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          fail("hierarchical (differential) JPEG is not supported");
        case 0xCB: fail("lossless JPEG (SOF11) is not supported");
        case 0xC4: read_dht(end); break;
        case 0xDB: read_dqt(end); break;
        case 0xDD:
          if (len != 4) fail("corrupt JPEG data: bad DRI length");
          restart = u16();
          break;
        case 0xDA:
          if (stop_at_frame) fail("scan before the frame header");
          read_scan(end);
          continue;  // the scan leaves pos after its data
        case 0xDC: fail("JPEG with a DNL marker is not supported");
        case 0xE0:
          if (len - 2 >= 14 && std::memcmp(d + pos, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:
          if (len - 2 >= 12 && std::memcmp(d + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[pos + 11];
          }
          break;
        case 0xCC: read_dac(end); break;
        default:
          if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) break;  // APPn, COM
          {
            char msg[64];
            std::snprintf(msg, sizeof msg, "unsupported JPEG marker 0x%02X", m);
            fail(msg);
          }
      }
      pos = end;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3 || prec > 1) fail("corrupt JPEG data: bad DQT table");
      for (int k = 0; k < 64; k++) qt[tq][kNatural[k]] = (uint16_t)(prec ? u16() : u8());
      qdef[tq] = true;
    }
    if (pos != end) fail("corrupt JPEG data: bad DQT length");
  }

  // jdmarker.c get_dac.
  void read_dac(size_t end) {
    while (pos + 2 <= end) {
      int index = u8(), val = u8();
      if (index >= 32) fail("corrupt JPEG data: bad DAC index");
      if (index >= 16) {
        dac_k[index - 16] = (uint8_t)val;
      } else {
        dac_l[index] = (uint8_t)(val & 15);
        dac_u[index] = (uint8_t)(val >> 4);
        if (dac_l[index] > dac_u[index]) fail("corrupt JPEG data: bad DAC value");
      }
    }
    if (pos != end) fail("corrupt JPEG data: bad DAC length");
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, th = tc & 15;
      if (cls > 1 || th > 3) fail("corrupt JPEG data: bad DHT table");
      Huffman& h = cls ? ac[th] : dc[th];
      int count = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; l++) count += (h.bits[l] = (uint8_t)u8());
      if (count > 256 || pos + count > end) fail("corrupt JPEG data: bad DHT table");
      std::memset(h.vals, 0, sizeof h.vals);
      for (int i = 0; i < count; i++) h.vals[i] = (uint8_t)u8();
      h.defined = true;
    }
    if (pos != end) fail("corrupt JPEG data: bad DHT length");
  }

  void read_frame(int m, size_t end) {
    if (frame) fail("corrupt JPEG data: two frame headers");
    frame = true;
    progressive = m == 0xC2 || m == 0xCA;
    arith = m == 0xC9 || m == 0xCA;
    int precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (precision != 8) {
      char msg[64];
      std::snprintf(msg, sizeof msg, "unsupported JPEG data precision %d (8 is)", precision);
      fail(msg);
    }
    if (height == 0) fail("JPEG with no height (DNL) is not supported");
    if (width == 0 || nc == 0) fail("empty JPEG image");
    if (nc != 1 && nc != 3) {
      char msg[96];
      std::snprintf(msg, sizeof msg, "JPEG with %d components is not supported (1 grey or 3 colour are)", nc);
      fail(msg);
    }
    if (end - pos != (size_t)nc * 3) fail("corrupt JPEG data: bad SOF length");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bogus JPEG sampling factors");
      if (c.tq > 3) fail("corrupt JPEG data: bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) fail("fractional JPEG sampling factors are not supported");
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.stride = mcux * c.h;
      c.rows = mcuy * c.v;
      c.coef.assign((size_t)c.stride * c.rows * 64, 0);
      for (int& b : c.coef_bits) b = -1;
    }
  }

  void read_scan(size_t end);

  // The scan's MCUs in order, with a restart every `restart` MCUs: the
  // RSTn marker must come next, and the entropy decoder starts afresh.
  template <class Entropy>
  void decode_mcus(const Scan& s, Entropy& e) {
    const int nx = s.ns == 1 ? s.sc[0]->bw : mcux, ny = s.ns == 1 ? s.sc[0]->bh : mcuy;
    const long total = (long)nx * ny;
    int rst = 0;
    for (long m = 0; m < total; m++) {
      if (restart && m > 0 && m % restart == 0) {
        pos = e.position();
        if (next_marker() != 0xD0 + rst) fail("corrupt JPEG data: missing restart marker");
        rst = (rst + 1) & 7;
        e.restart(pos);
      }
      const int my = (int)(m / nx), mx = (int)(m % nx);
      for (int i = 0; i < s.ns; i++) {
        Component& c = *s.sc[i];
        const int hh = s.ns == 1 ? 1 : c.h, vv = s.ns == 1 ? 1 : c.v;
        for (int by = 0; by < vv; by++)
          for (int bx = 0; bx < hh; bx++) e.block(i, c.block(my * vv + by, mx * hh + bx));
      }
    }
    pos = e.position();
  }

  void finish_check() {
    for (auto& c : comps)
      if (c.scans == 0) fail("premature end of JPEG data: a component has no scan");
    if (!progressive) return;
    // jdcoefct.c smoothing_ok: libjpeg smooths blocks whose first AC
    // coefficients lack bits; such a file was cut short or is bogus.
    static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool ok = true, useful = false;
    for (auto& c : comps) {
      for (int p : kQPos)
        if (c.qt[p] == 0) ok = false;
      if (c.coef_bits[0] < 0) ok = false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (ok && useful) fail("progressive JPEG whose scans stop early (libjpeg would smooth its blocks)");
  }
};

// Huffman-coded scans (jdhuff.c, jdphuff.c).
struct HuffmanScan {
  const Scan& s;
  BitReader br;
  const Huffman* dct[4] = {};
  const Huffman* act[4] = {};
  int pred[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  bool progressive;

  HuffmanScan(Decoder& dec, const Scan& scan) : s(scan), br(dec.d, dec.n, dec.pos), progressive(dec.progressive) {
    for (int i = 0; i < s.ns; i++) {  // the tables the scan reads must exist
      const bool need_dc = progressive ? (s.ss == 0 && s.ah == 0) : true;
      const bool need_ac = progressive ? s.ss > 0 : true;
      if ((need_dc && (s.td[i] > 3 || !dec.dc[s.td[i]].defined)) ||
          (need_ac && (s.ta[i] > 3 || !dec.ac[s.ta[i]].defined)))
        fail("JPEG Huffman table was not defined");
      if (need_dc) dec.dc[s.td[i]].derive(true);
      if (need_ac) dec.ac[s.ta[i]].derive(false);
      dct[i] = &dec.dc[s.td[i]];
      act[i] = &dec.ac[s.ta[i]];
    }
  }
  size_t position() const { return br.pos; }
  void restart(size_t p) {
    br = BitReader(br.d, br.n, p);
    pred[0] = pred[1] = pred[2] = pred[3] = 0;
    eobrun = 0;
  }
  void block(int i, int16_t* blk) {
    if (!progressive) {
      sequential(br, blk, *dct[i], *act[i], pred[i]);
    } else if (s.ss == 0) {
      if (s.ah == 0) {
        int v = br.decode(*dct[i]);
        if (v) v = extend(br.get(v), v);
        pred[i] += v;
        blk[0] = (int16_t)((unsigned)pred[i] << s.al);
      } else if (br.bit()) {
        blk[0] = (int16_t)(blk[0] | (1 << s.al));
      }
    } else if (s.ah == 0) {
      ac_first(br, blk, *act[i], s.ss, s.se, s.al, eobrun);
    } else {
      ac_refine(br, blk, *act[i], s.ss, s.se, s.al, eobrun);
    }
  }

  static void sequential(BitReader& br, int16_t* blk, const Huffman& dct, const Huffman& act, int& pred) {
    int s = br.decode(dct);
    if (s) s = extend(br.get(s), s);
    pred += s;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader& br, int16_t* blk, const Huffman& act, int ss, int se, int al,
                              unsigned& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)((unsigned)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1u << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine.
  static void ac_refine(BitReader& br, int16_t* blk, const Huffman& act, int ss, int se, int al,
                               unsigned& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG data: bad refinement code");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            if (br.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0 && br.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      eobrun--;
    }
  }

};

// jaricom.c jpeg_aritab (ITU T.81 Table D.2): Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS, and a last entry for the fixed
// probability 0.5.
#define V(i, qe, lps, mps, sw) (((long)(qe) << 16) | ((long)(mps) << 8) | ((long)(sw) << 7) | (lps))
const long kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),     V(2, 0x1114, 16, 3, 0),     V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),     V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),     V(9, 0x001a, 33, 10, 0),    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),   V(14, 0x5a7f, 15, 15, 1),   V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),   V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),   V(21, 0x09a1, 45, 22, 0),   V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),   V(26, 0x0240, 52, 27, 0),   V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),   V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),   V(33, 0x004e, 63, 34, 0),   V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),   V(38, 0x3a0d, 65, 39, 0),   V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),   V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),   V(45, 0x0e74, 74, 46, 0),   V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),   V(50, 0x05cd, 48, 51, 0),   V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),   V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),   V(57, 0x01a4, 55, 58, 0),   V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),   V(62, 0x00ab, 61, 63, 0),   V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),   V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),   V(69, 0x293c, 84, 70, 0),   V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),   V(74, 0x1424, 72, 75, 0),   V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),   V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),   V(81, 0x4d1c, 88, 82, 0),   V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),   V(86, 0x299a, 93, 87, 0),   V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),   V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),   V(93, 0x32b4, 99, 94, 0),   V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),  V(98, 0x41cf, 103, 99, 0),  V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0), V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0), V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// Arithmetic-coded scans (jdarith.c): the decoder of ITU T.81 D.2, reading
// zeros once it meets a marker (which is legal here), and the statistics
// bins of its contexts.
struct ArithScan {
  const Scan& s;
  const uint8_t* d;
  size_t n, pos;
  long c = 0, a = 0;
  int ct = -16;
  bool marker = false;
  bool progressive;
  const uint8_t *dac_l, *dac_u, *dac_k;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};

  ArithScan(Decoder& dec, const Scan& scan)
      : s(scan), d(dec.d), n(dec.n), pos(dec.pos), progressive(dec.progressive), dac_l(dec.dac_l),
        dac_u(dec.dac_u), dac_k(dec.dac_k) {
    restart(pos);
  }
  size_t position() const { return pos; }
  // At the scan's start and at each restart: the statistics the scan reads
  // and the DC predictions start afresh, and so does the decoder.
  void restart(size_t p) {
    for (int i = 0; i < s.ns; i++) {
      if (!progressive || (s.ss == 0 && s.ah == 0)) {
        std::memset(dc_stats[s.td[i]], 0, 64);
        last_dc[i] = dc_ctx[i] = 0;
      }
      if (!progressive || s.ss) std::memset(ac_stats[s.ta[i]], 0, 256);
    }
    pos = p;
    c = a = 0;
    ct = -16;
    marker = false;
  }
  int byte() {
    if (marker) return 0;
    if (pos >= n) fail("premature end of JPEG data (truncated file)");
    if (d[pos] != 0xFF) return d[pos++];
    size_t q = pos + 1;
    while (q < n && d[q] == 0xFF) q++;
    if (q >= n) fail("premature end of JPEG data (truncated file)");
    if (d[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    marker = true;  // pos stays on the marker's first 0xFF
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000L) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000L;
      }
      a <<= 1;
    }
    int sv = *st;
    long qe = kAritab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF), nm = (int)((qe >> 8) & 0xFF);
    qe >>= 16;
    long temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000L) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // Figures F.19, F.21-F.24: a DC difference, added to the prediction.
  void dc(int i, int16_t* blk, int shift) {
    const int tbl = s.td[i];
    uint8_t* st = dc_stats[tbl] + dc_ctx[i];
    if (decode(st) == 0) {
      dc_ctx[i] = 0;
    } else {
      const int sign = decode(st + 1);
      st += 2 + sign;
      int m = decode(st);
      if (m) {
        st = dc_stats[tbl] + 20;
        while (decode(st)) {
          if ((m <<= 1) == 0x8000) fail("corrupt JPEG data: bad arithmetic code");
          st++;
        }
      }
      if (m < ((1 << dac_l[tbl]) >> 1))
        dc_ctx[i] = 0;
      else if (m > ((1 << dac_u[tbl]) >> 1))
        dc_ctx[i] = 12 + sign * 4;
      else
        dc_ctx[i] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      last_dc[i] = (last_dc[i] + v) & 0xFFFF;
    }
    blk[0] = (int16_t)((unsigned)last_dc[i] << shift);
  }
  // Figure F.20: the AC coefficients ss..se, scaled by 2^al.
  void ac_first(int i, int16_t* blk, int ss, int se, int al) {
    const int tbl = s.ta[i];
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (decode(st)) break;  // end of block
      while (decode(st + 1) == 0) {
        st += 3;
        if (++k > se) fail("corrupt JPEG data: bad arithmetic code");
      }
      const int sign = decode(&fixed_bin);
      st += 2;
      int m = decode(st);
      if (m && decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
        while (decode(st)) {
          if ((m <<= 1) == 0x8000) fail("corrupt JPEG data: bad arithmetic code");
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)((unsigned)v << al);
    }
  }
  // jdarith.c decode_mcu_AC_refine.
  void ac_refine(int i, int16_t* blk) {
    const int tbl = s.ta[i], p1 = 1 << s.al, m1 = -1 * (1 << s.al);
    int kex = s.se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = s.ss; k <= s.se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && decode(st)) break;  // end of block
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (decode(st + 2)) *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (decode(st + 1)) {
          *coef = (int16_t)(decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > s.se) fail("corrupt JPEG data: bad arithmetic code");
      }
    }
  }
  void block(int i, int16_t* blk) {
    if (!progressive) {
      dc(i, blk, 0);
      ac_first(i, blk, 1, 63, 0);
    } else if (s.ss == 0) {
      if (s.ah == 0)
        dc(i, blk, s.al);
      else if (decode(&fixed_bin))
        blk[0] = (int16_t)(blk[0] | (1 << s.al));
    } else if (s.ah == 0) {
      ac_first(i, blk, s.ss, s.se, s.al);
    } else {
      ac_refine(i, blk);
    }
  }
};

void Decoder::read_scan(size_t end) {
  if (!frame) fail("corrupt JPEG data: scan before the frame header");
  int ns = u8();
  if (ns < 1 || ns > 4 || end - pos != (size_t)ns * 2 + 3) fail("corrupt JPEG data: bad SOS header");
  Component* sc[4];
  int td[4], ta[4];
  for (int i = 0; i < ns; i++) {
    int id = u8(), t = u8();
    sc[i] = nullptr;
    for (auto& c : comps)
      if (c.id == id) sc[i] = &c;
    if (!sc[i]) fail("corrupt JPEG data: scan of an unknown component");
    for (int j = 0; j < i; j++)
      if (sc[j] == sc[i]) fail("corrupt JPEG data: a component twice in one scan");
    td[i] = t >> 4;
    ta[i] = t & 15;
    if (td[i] > 3 || ta[i] > 3) fail("corrupt JPEG data: bad Huffman table index");
  }
  int ss = u8(), se = u8(), a = u8();
  int ah = a >> 4, al = a & 15;
  pos = end;
  for (int i = 0; i < ns; i++) {  // jdinput.c latch_quant_tables
    Component& c = *sc[i];
    if (!c.latched) {
      if (!qdef[c.tq]) fail("JPEG quantization table was not defined");
      for (int k = 0; k < 64; k++) c.qt[k] = (int16_t)qt[c.tq][k];
      c.latched = true;
    }
    c.scans++;
  }
  if (progressive) {
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail("invalid progressive JPEG scan parameters");
    for (int i = 0; i < ns; i++)
      for (int k = ss; k <= se; k++) sc[i]->coef_bits[k] = al;
  }
  int blocks_in_mcu = 0;
  for (int i = 0; i < ns; i++) blocks_in_mcu += ns == 1 ? 1 : sc[i]->h * sc[i]->v;
  if (blocks_in_mcu > 10) fail("JPEG MCU of more than 10 blocks");
  Scan scan{ns, {sc[0], sc[1], sc[2], sc[3]}, {td[0], td[1], td[2], td[3]}, {ta[0], ta[1], ta[2], ta[3]},
            ss, se, ah, al};
  if (arith) {
    ArithScan e(*this, scan);
    decode_mcus(scan, e);
  } else {
    HuffmanScan e(*this, scan);
    decode_mcus(scan, e);
  }
}


// ---------------------------------------------------------------------------
// jidctint.c jpeg_idct_islow and the range limit of jdmaster.c
// ---------------------------------------------------------------------------

struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int v = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
      idct[i] = (uint8_t)v;
    }
  }
};
const RangeLimit kRange;

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr long F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
               F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int out_stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dcval = ip[0] * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) wp[r * 8] = dcval;
      continue;
    }
    long z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    long z1 = (z2 + z3) * F0_541;
    long tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits), tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const uint8_t* rl = kRange.idct;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + (size_t)r * out_stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      uint8_t v = rl[(int)descale(wp[0], kPass1Bits + 3) & 1023];
      for (int i = 0; i < 8; i++) op[i] = v;
      continue;
    }
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * F0_541;
    long tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    long tmp0 = ((long)wp[0] + wp[4]) * (1L << kConstBits), tmp1 = ((long)wp[0] - wp[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = rl[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = rl[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = rl[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = rl[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = rl[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = rl[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = rl[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = rl[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ---------------------------------------------------------------------------
// jdsample.c upsampling to [height][width], with jdmainct.c's context rows:
// the first row above the image and the last row below it repeat.
// ---------------------------------------------------------------------------

void upsample(const Component& c, const uint8_t* plane, int pstride, int hmax, int vmax, int width, int height,
              uint8_t* out) {
  const int he = hmax / c.h, ve = vmax / c.v, dw = c.dw, dh = c.dh;
  if (he == 1 && ve == 1) {
    for (int y = 0; y < height; y++) std::memcpy(out + (size_t)y * width, plane + (size_t)y * pstride, width);
    return;
  }
  std::vector<uint8_t> row(2 * (size_t)dw + 2);
  if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; y++) {
      const uint8_t* s = plane + (size_t)y * pstride;
      uint8_t* o = row.data();
      for (int x = 0; x < dw; x++) {
        int l = s[x > 0 ? x - 1 : 0], r = s[x < dw - 1 ? x + 1 : dw - 1], t = 3 * s[x];
        o[2 * x] = (uint8_t)((t + l + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((t + r + 2) >> 2);
      }
      std::memcpy(out + (size_t)y * width, o, width);
    }
    return;
  }
  if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; y++) {
      int r = y >> 1, far = (y & 1) ? (r < dh - 1 ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* s0 = plane + (size_t)r * pstride;
      const uint8_t* s1 = plane + (size_t)far * pstride;
      uint8_t* o = out + (size_t)y * width;
      for (int x = 0; x < width; x++) o[x] = (uint8_t)((3 * s0[x] + s1[x] + bias) >> 2);
    }
    return;
  }
  if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> sum(dw);
    for (int y = 0; y < height; y++) {
      int r = y >> 1, far = (y & 1) ? (r < dh - 1 ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
      const uint8_t* s0 = plane + (size_t)r * pstride;
      const uint8_t* s1 = plane + (size_t)far * pstride;
      for (int x = 0; x < dw; x++) sum[x] = 3 * s0[x] + s1[x];
      uint8_t* o = row.data();
      for (int x = 0; x < dw; x++) {
        int t = 3 * sum[x], l = sum[x > 0 ? x - 1 : 0], rr = sum[x < dw - 1 ? x + 1 : dw - 1];
        o[2 * x] = (uint8_t)((t + l + 8) >> 4);
        o[2 * x + 1] = (uint8_t)((t + rr + 7) >> 4);
      }
      std::memcpy(out + (size_t)y * width, o, width);
    }
    return;
  }
  // int_upsample (and h2v1 / h2v2 replication for narrow components).
  for (int y = 0; y < height; y++) {
    const uint8_t* s = plane + (size_t)(y / ve) * pstride;
    uint8_t* o = out + (size_t)y * width;
    for (int x = 0; x < width; x++) o[x] = s[x / he];
  }
}

// jdcolor.c build_ycc_rgb_table.
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  uint8_t clamp[1024];  // sample_range_limit, from -384
  YccTables() {
    const int scale = 16;
    const long half = 1L << (scale - 1);
    auto fix = [](double x) { return (long)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> scale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> scale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    for (int i = 0; i < 1024; i++) {
      int v = i - 384;
      clamp[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const YccTables kYcc;

struct Shape {
  int h, w, c;
};

Shape read_shape(const uint8_t* data, size_t size) {
  Decoder dec(data, size);
  dec.read_header_until_frame_or_end(true);
  return {dec.height, dec.width, dec.comps.size() == 1 ? 1 : 3};
}

Shape decode(const uint8_t* data, size_t size, uint8_t* out, long cap) {
  Decoder dec(data, size);
  dec.read_header_until_frame_or_end(false);
  const int H = dec.height, W = dec.width, nc = (int)dec.comps.size();
  if ((long)H * W * (nc == 1 ? 1 : 3) > cap) fail("output buffer too small");
  std::vector<uint8_t> plane;
  std::vector<std::vector<uint8_t>> full(nc);
  for (int ci = 0; ci < nc; ci++) {
    Component& c = dec.comps[ci];
    const int ps = c.bw * 8;
    plane.assign((size_t)ps * c.bh * 8, 0);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.block(by, bx), c.qt, plane.data() + (size_t)by * 8 * ps + bx * 8, ps);
    if (nc == 1) {
      upsample(c, plane.data(), ps, dec.hmax, dec.vmax, W, H, out);
      return {H, W, 1};
    }
    full[ci].resize((size_t)H * W);
    upsample(c, plane.data(), ps, dec.hmax, dec.vmax, W, H, full[ci].data());
  }
  // jdapimin.c default_decompress_parms: JFIF means YCbCr, then Adobe's
  // transform, then the component ids.
  bool rgb;
  if (dec.jfif)
    rgb = false;
  else if (dec.adobe)
    rgb = dec.adobe_transform == 0;
  else
    rgb = !(dec.comps[0].id == 1 && dec.comps[1].id == 2 && dec.comps[2].id == 3) &&
          dec.comps[0].id == 'R' && dec.comps[1].id == 'G' && dec.comps[2].id == 'B';
  const size_t npx = (size_t)H * W;
  const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
  if (rgb) {
    for (size_t i = 0; i < npx; i++) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
  } else {
    const uint8_t* cl = kYcc.clamp + 384;
    for (size_t i = 0; i < npx; i++) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = cl[y + kYcc.cr_r[cr]];
      out[3 * i + 1] = cl[y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)];
      out[3 * i + 2] = cl[y + kYcc.cb_b[cb]];
    }
  }
  return {H, W, 3};
}

void put_message(char* msg, int cap, const char* text) {
  if (msg && cap > 0) {
    std::strncpy(msg, text, cap - 1);
    msg[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Header only: the output's height, width and channels (1 or 3).
// Returns 0, or 1 with a message.
int mp_jpeg_info(const unsigned char* data, long size, int* h, int* w, int* c, char* msg, int msg_cap) {
  try {
    Shape s = read_shape(data, (size_t)size);
    *h = s.h;
    *w = s.w;
    *c = s.c;
    return 0;
  } catch (const std::exception& e) {
    put_message(msg, msg_cap, e.what());
    return 1;
  }
}

// Decodes into `out` ([h, w] or [h, w, 3] uint8, at least `cap` bytes).
// Returns 0, or 1 with a message.
int mp_jpeg_decode(const unsigned char* data, long size, unsigned char* out, long cap, int* h, int* w, int* c,
                   char* msg, int msg_cap) {
  try {
    Shape s = decode(data, (size_t)size, out, cap);
    *h = s.h;
    *w = s.w;
    *c = s.c;
    return 0;
  } catch (const std::exception& e) {
    put_message(msg, msg_cap, e.what());
    return 1;
  }
}

// A batch in `n_threads` threads; rcs[i] is each file's return code.
// Returns the number of files that failed.
int mp_jpeg_decode_batch(int n, const unsigned char** bufs, const long* sizes, unsigned char** outs,
                         const long* caps, int* hs, int* ws, int* cs, int* rcs, int n_threads) {
  if (n <= 0) return 0;
  int hw = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if (hw > 0 && n_threads > hw) n_threads = hw;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;)
      rcs[i] = mp_jpeg_decode(bufs[i], sizes[i], outs[i], caps[i], &hs[i], &ws[i], &cs[i], nullptr, 0);
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; t++) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  int failed = 0;
  for (int i = 0; i < n; i++) failed += rcs[i] != 0;
  return failed;
}

}  // extern "C"
