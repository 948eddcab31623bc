// Writes JPEGs through the system libjpeg's compressor, for the image
// fixtures and tests of the PyTorch package's JPEG decoder: what PIL's
// options cannot ask of libjpeg, such as arithmetic coding (with its
// conditioning parameters) and any sampling factors. Built with
// `g++ -shared -fPIC ... -ljpeg` by tests/torch_image_fixtures.py where
// libjpeg's headers are installed; C ABI, bound with ctypes.

#include <csetjmp>
#include <cstdio>
#include <cstdlib>

#include <jpeglib.h>

namespace {

struct Err {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_error(j_common_ptr c) { longjmp(reinterpret_cast<Err*>(c->err)->jump, 1); }

}  // namespace

extern "C" {

// px: [h, w, nc] uint8 (nc 1 grey or 3 RGB); hv: (h, v) per component or
// null; dac: (L, U, K) for every table, or null for libjpeg's defaults.
// Returns 0 with *out (malloc'ed, free with mp_free) and *size, or 1.
int mp_write_jpeg(const unsigned char* px, int w, int h, int nc, int quality, int arith, int progressive,
                  int restart_rows, const int* hv, const int* dac, unsigned char** out, unsigned long* size) {
  jpeg_compress_struct ci;
  Err err;
  ci.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  *out = nullptr;
  *size = 0;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&ci);
    return 1;
  }
  jpeg_create_compress(&ci);
  jpeg_mem_dest(&ci, out, size);
  ci.image_width = w;
  ci.image_height = h;
  ci.input_components = nc;
  ci.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&ci);
  jpeg_set_quality(&ci, quality, TRUE);
  ci.arith_code = arith ? TRUE : FALSE;
  if (hv)
    for (int i = 0; i < nc; i++) {
      ci.comp_info[i].h_samp_factor = hv[2 * i];
      ci.comp_info[i].v_samp_factor = hv[2 * i + 1];
    }
  if (dac)
    for (int t = 0; t < NUM_ARITH_TBLS; t++) {
      ci.arith_dc_L[t] = (UINT8)dac[0];
      ci.arith_dc_U[t] = (UINT8)dac[1];
      ci.arith_ac_K[t] = (UINT8)dac[2];
    }
  ci.restart_in_rows = restart_rows;
  if (progressive) jpeg_simple_progression(&ci);
  jpeg_start_compress(&ci, TRUE);
  while (ci.next_scanline < ci.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(px + (size_t)ci.next_scanline * w * nc);
    jpeg_write_scanlines(&ci, &row, 1);
  }
  jpeg_finish_compress(&ci);
  jpeg_destroy_compress(&ci);
  return 0;
}

void mp_free(unsigned char* p) { free(p); }

}  // extern "C"
