// Native threaded JPEG frame loader for vfs_tpu.
//
// The reference framework leans on decord (C++/FFmpeg) for frame decode
// (SURVEY §2.9); this is the TPU-host equivalent: a libjpeg-backed worker
// pool that decodes batches of JPEG files into a caller-provided RGB
// buffer, with optional bilinear resize, releasing the GIL for the whole
// batch (called via ctypes from vfs_tpu.datasets.native_loader).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 frame_loader.cpp -ljpeg -lpthread
//        -o libframe_loader.so

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct DecodeResult {
  std::vector<uint8_t> pixels;  // RGB8
  int height = 0;
  int width = 0;
  bool ok = false;
};

DecodeResult decode_jpeg_file(const char* path) {
  DecodeResult result;
  FILE* file = std::fopen(path, "rb");
  if (file == nullptr) return result;

  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, file);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    return result;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  result.width = static_cast<int>(cinfo.output_width);
  result.height = static_cast<int>(cinfo.output_height);
  const int row_stride = result.width * 3;
  result.pixels.resize(static_cast<size_t>(result.height) * row_stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = result.pixels.data() +
                   static_cast<size_t>(cinfo.output_scanline) * row_stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(file);
  result.ok = true;
  return result;
}

// Bilinear resize with half-pixel centers (cv2 INTER_LINEAR parity).
void resize_bilinear_rgb(const uint8_t* src, int sh, int sw, uint8_t* dst,
                         int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float top = src[(y0 * sw + x0) * 3 + c] * (1 - wx) +
                          src[(y0 * sw + x1) * 3 + c] * wx;
        const float bot = src[(y1 * sw + x0) * 3 + c] * (1 - wx) +
                          src[(y1 * sw + x1) * 3 + c] * wx;
        const float v = top * (1 - wy) + bot * wy;
        dst[(y * dw + x) * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode n JPEG files into out (n, out_h, out_w, 3) uint8 RGB. If
// out_h/out_w are 0, frames must share the native size given by
// native_h/native_w (probed with fl_probe). Returns the number of
// successfully decoded frames.
int fl_decode_batch(const char** paths, int n, int out_h, int out_w,
                    uint8_t* out, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads <= 0) num_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> ok_count(0);

  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      DecodeResult res = decode_jpeg_file(paths[i]);
      if (!res.ok) continue;
      uint8_t* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
      if (res.height == out_h && res.width == out_w) {
        std::memcpy(dst, res.pixels.data(),
                    static_cast<size_t>(out_h) * out_w * 3);
      } else {
        resize_bilinear_rgb(res.pixels.data(), res.height, res.width, dst,
                            out_h, out_w);
      }
      ok_count.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  const int nt = num_threads < n ? num_threads : n;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

// Decode n JPEG files straight to packed planar I420 (full-range JFIF
// YCbCr — the values the file stores; no RGB conversion on the host).
// out is (n, h*w*3/2) uint8: Y plane then 2x2-top-left-subsampled Cb, Cr
// (plain upsampling is forced so even-coordinate samples equal the
// stored chroma exactly for 4:2:0 sources). Frames whose native size is
// not exactly (h, w) are skipped (caller probes + falls back to the RGB
// path). h and w must be even. Returns the number decoded.
int fl_decode_batch_yuv420(const char** paths, int n, int h, int w,
                           uint8_t* out, int num_threads) {
  if (n <= 0 || h % 2 || w % 2) return 0;
  if (num_threads <= 0) num_threads = 1;
  const size_t frame_bytes = static_cast<size_t>(h) * w * 3 / 2;
  std::atomic<int> next(0);
  std::atomic<int> ok_count(0);

  auto worker = [&]() {
    std::vector<uint8_t> row_buf;
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      FILE* file = std::fopen(paths[i], "rb");
      if (file == nullptr) continue;
      jpeg_decompress_struct cinfo;
      jpeg_error_mgr jerr;
      cinfo.err = jpeg_std_error(&jerr);
      jpeg_create_decompress(&cinfo);
      jpeg_stdio_src(&cinfo, file);
      if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK ||
          static_cast<int>(cinfo.image_height) != h ||
          static_cast<int>(cinfo.image_width) != w) {
        jpeg_destroy_decompress(&cinfo);
        std::fclose(file);
        continue;
      }
      cinfo.out_color_space = JCS_YCbCr;
      cinfo.do_fancy_upsampling = FALSE;  // even coords == stored chroma
      jpeg_start_decompress(&cinfo);
      row_buf.resize(static_cast<size_t>(w) * 3 * 2);
      uint8_t* dst = out + static_cast<size_t>(i) * frame_bytes;
      uint8_t* yp = dst;
      uint8_t* up = dst + static_cast<size_t>(h) * w;
      uint8_t* vp = up + static_cast<size_t>(h) * w / 4;
      while (cinfo.output_scanline < cinfo.output_height) {
        const int y = static_cast<int>(cinfo.output_scanline);
        uint8_t* row = row_buf.data() + (y % 2) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
        uint8_t* yrow = yp + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) yrow[x] = row[x * 3];
        if (y % 2 == 0) {
          uint8_t* urow = up + static_cast<size_t>(y / 2) * (w / 2);
          uint8_t* vrow = vp + static_cast<size_t>(y / 2) * (w / 2);
          for (int x = 0; x < w; x += 2) {
            urow[x / 2] = row[x * 3 + 1];
            vrow[x / 2] = row[x * 3 + 2];
          }
        }
      }
      jpeg_finish_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      std::fclose(file);
      ok_count.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  const int nt = num_threads < n ? num_threads : n;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

// Probe a JPEG's native (height, width). Returns 1 on success.
int fl_probe(const char* path, int* height, int* width) {
  FILE* file = std::fopen(path, "rb");
  if (file == nullptr) return 0;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, file);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    return 0;
  }
  *height = static_cast<int>(cinfo.image_height);
  *width = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(file);
  return 1;
}

}  // extern "C"
