// Native image decode for the input pipeline.
//
// A copy of megapose6d_tpu/native/decode.cc for the PyTorch package:
// libpng/libjpeg decode with an in-process std::thread pool, exposed
// through a C ABI and bound with ctypes (megapose6d_tpu_torch/native/
// __init__.py). It runs on the host, in the batch loader's workers; the
// GIL is released for the whole batch while C++ fans out.
//
// Supported: 8-bit PNG (gray/gray+alpha/RGB/RGBA/palette), 16-bit
// grayscale PNG (BOP depth maps, returned as native-endian uint16),
// baseline+progressive JPEG (as RGB). Errors return negative codes, never
// longjmp across the ABI.

#include <cstddef>
#include <cstdio>  // jpeglib.h uses size_t/FILE without including them

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Error codes.
enum {
  MP_OK = 0,
  MP_ERR_FORMAT = -1,    // not a PNG/JPEG
  MP_ERR_DECODE = -2,    // corrupt stream
  MP_ERR_CAPACITY = -3,  // output buffer too small
  MP_ERR_UNSUPPORTED = -4,
};

struct MemSource {
  const unsigned char* data;
  size_t size;
  size_t pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  MemSource* src = (MemSource*)png_get_io_ptr(png);
  if (src->pos + n > src->size) {
    png_error(png, "read past end");
  }
  std::memcpy(out, src->data + src->pos, n);
  src->pos += n;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

static int decode_png(const unsigned char* data, long size, unsigned char* out,
                      long out_cap, int* h, int* w, int* c, int* bitdepth) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return MP_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return MP_ERR_DECODE;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return MP_ERR_DECODE;
  }
  MemSource src{data, (size_t)size, 0};
  png_set_read_fn(png, &src, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (depth == 16) {
    // BOP depth maps: keep 16-bit, native endianness (PNG is big-endian).
    if (color != PNG_COLOR_TYPE_GRAY) {
      png_destroy_read_struct(&png, &info, nullptr);
      return MP_ERR_UNSUPPORTED;
    }
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    png_set_swap(png);
#endif
  } else {
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
      png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (depth < 8) png_set_packing(png);
  }
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  size_t need = rowbytes * height;
  *h = (int)height;
  *w = (int)width;
  *c = channels;
  *bitdepth = depth == 16 ? 16 : 8;
  if ((long)need > out_cap) {
    png_destroy_read_struct(&png, &info, nullptr);
    return MP_ERR_CAPACITY;
  }
  rows.resize(height);
  for (png_uint_32 y = 0; y < height; y++) rows[y] = out + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return MP_OK;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = (JpegErr*)cinfo->err;
  longjmp(err->jump, 1);
}

static int decode_jpeg(const unsigned char* data, long size,
                       unsigned char* out, long out_cap, int* h, int* w,
                       int* c, int* bitdepth) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return MP_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), (unsigned long)size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = cinfo.num_components == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int channels = cinfo.output_components;
  size_t rowbytes = (size_t)cinfo.output_width * channels;
  size_t need = rowbytes * cinfo.output_height;
  *h = (int)cinfo.output_height;
  *w = (int)cinfo.output_width;
  *c = channels;
  *bitdepth = 8;
  if ((long)need > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return MP_ERR_CAPACITY;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + (size_t)cinfo.output_scanline * rowbytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return MP_OK;
}

// ---------------------------------------------------------------------------
// Public ABI
// ---------------------------------------------------------------------------

static const unsigned char PNG_MAGIC[8] = {0x89, 'P',  'N',  'G',
                                           0x0d, 0x0a, 0x1a, 0x0a};

int mp_image_info(const unsigned char* data, long size, int* h, int* w,
                  int* c, int* bitdepth) {
  if (size >= 8 && std::memcmp(data, PNG_MAGIC, 8) == 0) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      return MP_ERR_DECODE;
    }
    MemSource src{data, (size_t)size, 0};
    png_set_read_fn(png, &src, png_mem_read);
    png_read_info(png, info);
    *h = (int)png_get_image_height(png, info);
    *w = (int)png_get_image_width(png, info);
    int depth = png_get_bit_depth(png, info);
    int color = png_get_color_type(png, info);
    int channels = png_get_channels(png, info);
    if (color == PNG_COLOR_TYPE_PALETTE) channels = 3;
    if (png_get_valid(png, info, PNG_INFO_tRNS)) channels += 1;
    *c = channels;
    *bitdepth = depth == 16 ? 16 : 8;
    png_destroy_read_struct(&png, &info, nullptr);
    return MP_OK;
  }
  if (size >= 3 && data[0] == 0xFF && data[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      return MP_ERR_DECODE;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 (unsigned long)size);
    jpeg_read_header(&cinfo, TRUE);
    *h = (int)cinfo.image_height;
    *w = (int)cinfo.image_width;
    *c = cinfo.num_components == 1 ? 1 : 3;
    *bitdepth = 8;
    jpeg_destroy_decompress(&cinfo);
    return MP_OK;
  }
  return MP_ERR_FORMAT;
}

int mp_decode_image(const unsigned char* data, long size, unsigned char* out,
                    long out_cap, int* h, int* w, int* c, int* bitdepth) {
  if (size >= 8 && std::memcmp(data, PNG_MAGIC, 8) == 0)
    return decode_png(data, size, out, out_cap, h, w, c, bitdepth);
  if (size >= 3 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, size, out, out_cap, h, w, c, bitdepth);
  return MP_ERR_FORMAT;
}

// Batch decode with an std::thread pool. Returns MP_OK or the first error.
int mp_decode_batch(int n, const unsigned char** bufs, const long* sizes,
                    unsigned char** outs, const long* caps, int* hs, int* ws,
                    int* cs, int* bds, int n_threads) {
  if (n <= 0) return MP_OK;
  if (n_threads <= 0) n_threads = 1;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw > 0 && n_threads > hw) n_threads = hw;
  if (n_threads > n) n_threads = n;

  std::vector<int> rc(n, MP_OK);
  std::vector<std::thread> pool;
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      rc[i] = mp_decode_image(bufs[i], sizes[i], outs[i], caps[i], &hs[i],
                              &ws[i], &cs[i], &bds[i]);
    }
  };
  for (int t = 0; t < n_threads; t++) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; i++)
    if (rc[i] != MP_OK) return rc[i];
  return MP_OK;
}

}  // extern "C"
