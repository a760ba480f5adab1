// PNG decoding for the port's host runtime: the Kinect RGB (8-bit color)
// and disparity (16-bit gray) frames, one file or a batch on a thread pool.
//
// A copy of the PNG half of native/slamio.cpp (lidar_slam_tpu/utils/
// native.py binds that one), kept in its own translation unit because it
// alone needs libpng: lidar_slam_tpu_torch/utils/native.py builds it with
//     g++ -O3 -fno-math-errno -fno-trapping-math -fPIC -std=c++17 -Wall
//         -shared slampng.cpp -o libslampng_<hash>.so -lpng -lz -lpthread
// and decodes in Python where it does not build (the bytes are equal).
// C ABI for ctypes.

#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct PngImage {
  int width = 0;
  int height = 0;
  int channels = 0;
  int bit_depth = 0;
  std::vector<uint8_t> data;  // row-major, 16-bit stored big-endian by libpng
};

// rc: 0 ok, 1 open fail, 2 not png, 3 decode error
int read_png_file(const char* path, PngImage* out, bool header_only) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  uint8_t sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return 2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int color_type = png_get_color_type(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  out->width = png_get_image_width(png, info);
  out->height = png_get_image_height(png, info);

  // normalize: palette -> rgb, gray<8 -> 8
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && out->bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  out->channels = png_get_channels(png, info);
  out->bit_depth = png_get_bit_depth(png, info);

  if (header_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
  }

  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(rowbytes * out->height);
  std::vector<png_bytep> rows(out->height);
  for (int y = 0; y < out->height; ++y)
    rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

}  // namespace

extern "C" {

int slamio_read_png_info(const char* path, int* width, int* height,
                         int* channels, int* bit_depth) {
  PngImage img;
  int rc = read_png_file(path, &img, /*header_only=*/true);
  if (rc) return rc;
  *width = img.width;
  *height = img.height;
  *channels = img.channels;
  *bit_depth = img.bit_depth;
  return 0;
}

int slamio_read_png_u8(const char* path, uint8_t* out) {
  PngImage img;
  int rc = read_png_file(path, &img, false);
  if (rc) return rc;
  if (img.bit_depth != 8) return 4;
  std::memcpy(out, img.data.data(),
              (size_t)img.width * img.height * img.channels);
  return 0;
}

int slamio_read_png_u16(const char* path, uint16_t* out) {
  PngImage img;
  int rc = read_png_file(path, &img, false);
  if (rc) return rc;
  if (img.bit_depth != 16) return 4;
  size_t n = (size_t)img.width * img.height * img.channels;
  // libpng delivers 16-bit samples big-endian
  const uint8_t* src = img.data.data();
  for (size_t i = 0; i < n; ++i)
    out[i] = (uint16_t)((src[2 * i] << 8) | src[2 * i + 1]);
  return 0;
}

// Batch decode: paths packed as NUL-separated; each image decoded into its
// slot of `out` (stride bytes apart) by a thread pool. All images must share
// (width, height, channels, bit_depth). rcs[i] receives per-file status.
int slamio_read_png_batch_u16(const char** paths, int n, uint16_t* out,
                              long long stride_elems, int* rcs, int n_threads) {
  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  std::mutex m;
  auto worker = [&]() {
    for (;;) {
      int i;
      {
        std::lock_guard<std::mutex> lk(m);
        if (next[0] >= n) return;
        i = next[0]++;
      }
      rcs[i] = slamio_read_png_u16(paths[i], out + (long long)i * stride_elems);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

int slamio_read_png_batch_u8(const char** paths, int n, uint8_t* out,
                             long long stride_elems, int* rcs, int n_threads) {
  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  std::mutex m;
  auto worker = [&]() {
    for (;;) {
      int i;
      {
        std::lock_guard<std::mutex> lk(m);
        if (next[0] >= n) return;
        i = next[0]++;
      }
      rcs[i] = slamio_read_png_u8(paths[i], out + (long long)i * stride_elems);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
