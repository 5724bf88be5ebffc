// Native image pipeline: multithreaded JPEG/PNG decode -> box-halving
// downsample -> bilinear resize -> center crop -> float32 [-1,1] NHWC.
// (A copy of loco_edit_tpu/native/imagepipe.cpp for the PyTorch port.)
//
// The host-side counterpart of the reference's host data path (PIL +
// torchvision transforms in src/models/guided_diffusion/image_datasets.py
// :126-165 and the dataset loaders in src/utils/utils.py:472-673): image
// decode and preprocessing are the host bottleneck when feeding 256px
// batches to a fast chip, so they run here in C++ with a thread pool,
// exposed to Python via ctypes (loco_edit_tpu_torch/native/__init__.py).
//
// Build: g++ -O3 -shared -fPIC imagepipe.cpp -o libimagepipe.so -ljpeg -lpng

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
  bool ok = false;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

Image decode_jpeg(FILE* f) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.rgb.resize(size_t(img.w) * img.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.rgb.data() + size_t(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}

Image decode_png(FILE* f) {
  Image img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);           // palettes / bit-depths -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  img.w = png_get_image_width(png, info);
  img.h = png_get_image_height(png, info);
  img.rgb.resize(size_t(img.w) * img.h * 3);
  std::vector<png_bytep> rows(img.h);
  for (int y = 0; y < img.h; y++)
    rows[y] = img.rgb.data() + size_t(y) * img.w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  img.ok = true;
  return img;
}

Image decode_file(const char* path) {
  Image img;
  FILE* f = fopen(path, "rb");
  if (!f) return img;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    img = decode_jpeg(f);
  } else if (n >= 8 && !png_sig_cmp(magic, 0, 8)) {
    img = decode_png(f);
  }
  fclose(f);
  return img;
}

// exact 2x box downsample (matches PIL Image.BOX at factor 2)
Image box_halve(const Image& in) {
  Image out;
  out.w = in.w / 2;
  out.h = in.h / 2;
  out.rgb.resize(size_t(out.w) * out.h * 3);
  for (int y = 0; y < out.h; y++) {
    const uint8_t* r0 = in.rgb.data() + size_t(2 * y) * in.w * 3;
    const uint8_t* r1 = r0 + size_t(in.w) * 3;
    uint8_t* dst = out.rgb.data() + size_t(y) * out.w * 3;
    for (int x = 0; x < out.w; x++) {
      for (int c = 0; c < 3; c++) {
        int s = r0[(2 * x) * 3 + c] + r0[(2 * x + 1) * 3 + c] +
                r1[(2 * x) * 3 + c] + r1[(2 * x + 1) * 3 + c];
        dst[x * 3 + c] = uint8_t((s + 2) >> 2);
      }
    }
  }
  out.ok = true;
  return out;
}

// bilinear resize (align-corners=false convention, like PIL)
Image bilinear(const Image& in, int ow, int oh) {
  Image out;
  out.w = ow;
  out.h = oh;
  out.rgb.resize(size_t(ow) * oh * 3);
  const float sx = float(in.w) / ow, sy = float(in.h) / oh;
  for (int y = 0; y < oh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y1 = y0 + 1;
    y0 = y0 < 0 ? 0 : (y0 >= in.h ? in.h - 1 : y0);
    y1 = y1 < 0 ? 0 : (y1 >= in.h ? in.h - 1 : y1);
    uint8_t* dst = out.rgb.data() + size_t(y) * ow * 3;
    for (int x = 0; x < ow; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x1 = x0 + 1;
      x0 = x0 < 0 ? 0 : (x0 >= in.w ? in.w - 1 : x0);
      x1 = x1 < 0 ? 0 : (x1 >= in.w ? in.w - 1 : x1);
      for (int c = 0; c < 3; c++) {
        float v00 = in.rgb[(size_t(y0) * in.w + x0) * 3 + c];
        float v01 = in.rgb[(size_t(y0) * in.w + x1) * 3 + c];
        float v10 = in.rgb[(size_t(y1) * in.w + x0) * 3 + c];
        float v11 = in.rgb[(size_t(y1) * in.w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[x * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
  out.ok = true;
  return out;
}

// the reference crop pipeline: halve while min-side >= 2*size, scale so the
// min side == size, center-crop size x size, normalize to [-1, 1]
bool load_one(const char* path, int size, float* out) {
  Image img = decode_file(path);
  if (!img.ok || img.w == 0 || img.h == 0) return false;
  while (std::min(img.w, img.h) >= 2 * size) img = box_halve(img);
  float scale = float(size) / std::min(img.w, img.h);
  int nw = int(roundf(img.w * scale)), nh = int(roundf(img.h * scale));
  img = bilinear(img, nw < size ? size : nw, nh < size ? size : nh);
  int cx = (img.w - size) / 2, cy = (img.h - size) / 2;
  for (int y = 0; y < size; y++) {
    const uint8_t* src =
        img.rgb.data() + (size_t(cy + y) * img.w + cx) * 3;
    float* dst = out + size_t(y) * size * 3;
    for (int i = 0; i < size * 3; i++) dst[i] = src[i] / 127.5f - 1.0f;
  }
  return true;
}

}  // namespace

extern "C" {

// decode to uint8 RGB; caller provides max buffer; returns 0 on success
int ip_decode(const char* path, uint8_t* buf, int64_t buf_len, int* w, int* h) {
  Image img = decode_file(path);
  if (!img.ok) return 1;
  if ((int64_t)img.rgb.size() > buf_len) return 2;
  memcpy(buf, img.rgb.data(), img.rgb.size());
  *w = img.w;
  *h = img.h;
  return 0;
}

// batch load: n paths (null-separated) -> out (n, size, size, 3) f32 [-1,1]
// returns number of failed images (their slots are zeroed)
int ip_load_batch(const char* paths, int n, int size, float* out,
                  int n_threads) {
  std::vector<const char*> ptrs(n);
  const char* p = paths;
  for (int i = 0; i < n; i++) {
    ptrs[i] = p;
    p += strlen(p) + 1;
  }
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      float* dst = out + size_t(i) * size * size * 3;
      if (!load_one(ptrs[i], size, dst)) {
        memset(dst, 0, sizeof(float) * size_t(size) * size * 3);
        failed.fetch_add(1);
      }
    }
  };
  int nt = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (nt > n) nt = n;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int i = 0; i < nt; i++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failed.load();
}

}  // extern "C"
