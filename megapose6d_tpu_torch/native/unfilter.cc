// PNG row unfiltering (the five filters of the PNG specification, 9.2),
// for the PyTorch package's own PNG decoder (utils/png.py) where libpng is
// not installed: Python's zlib inflates the image data, this undoes the
// filters in one pass over the rows, byte for byte what png.py's numpy
// unfilter gives. Needs nothing but a C++ compiler; C ABI, bound with
// ctypes (megapose6d_tpu_torch/native/__init__.py).

#include <cstddef>
#include <cstdlib>

extern "C" {

// filtered: [h, w * bpp] bytes after each row's filter-type byte,
// ftype: [h], out: [h, w * bpp]. Returns 0, or -1 for an unknown filter.
int mp_png_unfilter(const unsigned char* filtered, const unsigned char* ftype, int h, int w, int bpp,
                    unsigned char* out) {
  const size_t stride = static_cast<size_t>(w) * bpp;
  for (int y = 0; y < h; ++y) {
    const unsigned char* f = filtered + y * stride;
    unsigned char* o = out + y * stride;
    const unsigned char* up = y > 0 ? out + (y - 1) * stride : nullptr;
    const int t = ftype[y];
    if (t > 4) return -1;
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= static_cast<size_t>(bpp) ? o[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= static_cast<size_t>(bpp)) ? up[i - bpp] : 0;
      int p = 0;
      if (t == 1) {
        p = a;
      } else if (t == 2) {
        p = b;
      } else if (t == 3) {
        p = (a + b) >> 1;
      } else if (t == 4) {
        const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
        p = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      }
      o[i] = static_cast<unsigned char>(f[i] + p);
    }
  }
  return 0;
}

}  // extern "C"
