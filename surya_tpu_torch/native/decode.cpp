// Host-side input pipeline: multithreaded JPEG decode + bilinear resize
// into a pre-allocated uint8 NHWC batch buffer (a copy of
// surya_tpu/native/decode.cpp).
//
// Single-threaded PIL decode (a few ms an image, under the GIL) cannot
// feed a training step; this library decodes a whole batch across
// std::threads with libjpeg, with no Python involved until the filled
// buffer returns. Bound with ctypes in surya_tpu_torch/native/__init__.py.
//
// API (C ABI):
//   int surya_decode_batch(const char** paths, int n, int out_size,
//                          unsigned char* out, int n_threads);
// Returns the number of successfully decoded images; failed slots are
// zero-filled.

#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize HWC uint8 (src h×w) → (out_size×out_size).
void resize_bilinear(const unsigned char* src, int h, int w,
                     unsigned char* dst, int out_size) {
  const float sy = static_cast<float>(h) / out_size;
  const float sx = static_cast<float>(w) / out_size;
  for (int oy = 0; oy < out_size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int ox = 0; ox < out_size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      const unsigned char* p00 = src + (y0 * w + x0) * 3;
      const unsigned char* p01 = src + (y0 * w + x1) * 3;
      const unsigned char* p10 = src + (y1 * w + x0) * 3;
      const unsigned char* p11 = src + (y1 * w + x1) * 3;
      unsigned char* o = dst + (oy * out_size + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        float v = top * (1 - wy) + bot * wy;
        o[c] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

bool decode_one(const char* path, int out_size, unsigned char* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<unsigned char> pixels;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // gray/YCbCr → RGB
  // DCT-scaled decode: pick the smallest power-of-two 1/d (d=8,4,2)
  // whose scaled output still covers out_size in BOTH dimensions, so
  // the final bilinear only ever downscales. Power-of-two only: these
  // hit libjpeg-turbo's SIMD 1x1/2x2/4x4 IDCT kernels; odd M/8 ratios
  // fall back to scalar C IDCTs and measured *slower* than a full
  // decode (165 vs 177 img/s at 5/8, 480x640 noise) — see BENCH_NOTES.
  // Any libjpeg reports the real scaled dims via output_width/height,
  // which the resize below consumes, so an unsupported ratio degrades
  // gracefully.
  {
    unsigned int denom = 1;
    for (unsigned int cand = 8; cand > 1; cand /= 2) {
      if (static_cast<unsigned long>(cinfo.image_width) / cand >=
              static_cast<unsigned long>(out_size) &&
          static_cast<unsigned long>(cinfo.image_height) / cand >=
              static_cast<unsigned long>(out_size)) {
        denom = cand;
        break;
      }
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  // Cap the decode buffer (~100 MP ≈ 300 MB RGB): a crafted header can
  // declare 65535x65535, and a bad_alloc from resize() inside a worker
  // thread would std::terminate the whole process.
  if (cinfo.output_components != 3 || w <= 0 || h <= 0 ||
      static_cast<size_t>(w) * h > 100000000ull) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  try {
    pixels.resize(static_cast<size_t>(w) * h * 3);
  } catch (const std::bad_alloc&) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels.data()
        + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  resize_bilinear(pixels.data(), h, w, out, out_size);
  return true;
}

}  // namespace

extern "C" int surya_decode_batch(const char** paths, int n,
                                  int out_size, unsigned char* out,
                                  int n_threads) {
  const size_t stride = static_cast<size_t>(out_size) * out_size * 3;
  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      unsigned char* slot = out + stride * i;
      bool good = false;
      try {
        good = decode_one(paths[i], out_size, slot);
      } catch (...) {
        // an exception escaping a std::thread calls std::terminate —
        // uphold the zero-filled-failure contract instead
        good = false;
      }
      if (good) {
        ok.fetch_add(1);
      } else {
        std::memset(slot, 0, stride);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}
