// TIFF's LZW and PackBits strip decoders, for the PyTorch package's own TIFF
// reader (utils/tiff.py), byte for byte what its Python twins lzw_decode and
// packbits_decode give. Needs nothing but a C++ compiler; C ABI, bound with
// ctypes (megapose6d_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// TIFF LZW (compression 5): codes MSB first, 9 to 12 bits, the width growing
// one code early (at 511, 1023 and 2047 entries), 256 clears the table and
// 257 ends the data; libtiff tolerates entries past 4095 at 12 bits up to
// 5119. Writes at most `cap` bytes; returns the count, or -1 on a code not
// yet defined or a table that overflows.
long mp_tiff_lzw(const unsigned char* src, long n, unsigned char* out, long cap) {
  const int kTable = 5119;
  std::vector<int32_t> prefix(kTable + 1), length(kTable + 1);
  std::vector<uint8_t> first(kTable + 1), last(kTable + 1);
  for (int i = 0; i < 256; i++) {
    prefix[i] = -1;
    length[i] = 1;
    first[i] = last[i] = (uint8_t)i;
  }
  std::vector<uint8_t> tmp;
  int next = 258, nbits = 9, prev = -1;
  uint64_t acc = 0;
  int nacc = 0;
  long pos = 0, w = 0;
  while (w < cap) {
    while (nacc < nbits && pos < n) {
      acc = (acc << 8) | src[pos++];
      nacc += 8;
    }
    if (nacc < nbits) break;
    int code = (int)((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
    nacc -= nbits;
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      nbits = 9;
      prev = -1;
      continue;
    }
    int entry;
    if (code < next && (code < 256 || code > 257)) {
      entry = code;
      if (prev >= 0) {
        prefix[next] = prev;
        length[next] = length[prev] + 1;
        first[next] = first[prev];
        last[next] = first[code];
        next++;
      }
    } else if (code == next && prev >= 0) {
      prefix[next] = prev;
      length[next] = length[prev] + 1;
      first[next] = first[prev];
      last[next] = first[prev];
      entry = next++;
    } else {
      return -1;
    }
    if (next > kTable) return -1;
    // Write the entry's bytes, last to first, clipped to the output.
    const int len = length[entry];
    tmp.resize(len);
    for (int e = entry, i = len - 1; i >= 0; i--, e = prefix[e]) tmp[i] = last[e];
    const long k = len < cap - w ? len : cap - w;
    std::memcpy(out + w, tmp.data(), k);
    w += k;
    prev = entry;
    nbits = next >= 2047 ? 12 : next >= 1023 ? 11 : next >= 511 ? 10 : 9;
  }
  return w;
}

// PackBits (compression 32773). Writes at most `cap` bytes; returns the count.
long mp_tiff_packbits(const unsigned char* src, long n, unsigned char* out, long cap) {
  long i = 0, w = 0;
  while (i < n && w < cap) {
    int c = src[i++];
    if (c < 128) {
      long k = c + 1;
      if (k > n - i) k = n - i;
      if (k > cap - w) k = cap - w;
      std::memcpy(out + w, src + i, k);
      w += k;
      i += c + 1;
    } else if (c > 128) {
      if (i < n) {
        long k = 257 - c;
        if (k > cap - w) k = cap - w;
        std::memset(out + w, src[i], k);
        w += k;
      }
      i++;
    }
  }
  return w;
}

}  // extern "C"
