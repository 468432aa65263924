// Native threaded image-loading + augmentation pipeline of the port's data
// side (a copy of the JAX package's loader, so the port builds it on its own).
//
// A C++ worker pool decodes JPEG/PNG (libjpeg / libpng), pairs `*_mask.png`
// foreground masks, applies the dataset's augmentation (a single NEAREST
// resample of the image+mask stack, random horizontal flip, uniform center
// scale in [lo, hi] with zero padding, empty-margin random roll producing
// the aug mask), and prefetches ready examples into a bounded queue so host
// preprocessing overlaps device compute.
//
// C ABI (extern "C") consumed through ctypes by
// `adaface_tpu_torch/data/native_loader.py`; no pybind11 dependency.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

bool ends_with(const std::string& s, const std::string& suf) {
  return s.size() >= suf.size() &&
         s.compare(s.size() - suf.size(), suf.size(), suf) == 0;
}

bool decode_jpeg(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

bool decode_png(const std::string& path, Image* out, bool gray) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  if (gray) {
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  } else if (png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY ||
             png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY_ALPHA) {
    png_set_gray_to_rgb(png);
  }
  png_read_update_info(png, info);
  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  out->c = gray ? 1 : 3;
  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(size_t(out->h) * rowbytes);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; y++)
    rows[y] = out->data.data() + size_t(y) * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

bool decode(const std::string& path, Image* out, bool gray = false) {
  if (ends_with(path, ".png") || ends_with(path, ".PNG"))
    return decode_png(path, out, gray);
  return decode_jpeg(path, out);
}

// torch-NEAREST semantics: src = floor(dst * in / out)
void nearest_resize(const Image& in, int size, Image* out) {
  out->h = out->w = size;
  out->c = in.c;
  out->data.resize(size_t(size) * size * in.c);
  for (int y = 0; y < size; y++) {
    int sy = int(int64_t(y) * in.h / size);
    for (int x = 0; x < size; x++) {
      int sx = int(int64_t(x) * in.w / size);
      memcpy(&out->data[(size_t(y) * size + x) * in.c],
             &in.data[(size_t(sy) * in.w + sx) * in.c], in.c);
    }
  }
}

void hflip(Image* img) {
  for (int y = 0; y < img->h; y++)
    for (int x = 0; x < img->w / 2; x++)
      for (int ch = 0; ch < img->c; ch++)
        std::swap(img->data[(size_t(y) * img->w + x) * img->c + ch],
                  img->data[(size_t(y) * img->w + img->w - 1 - x) * img->c + ch]);
}

// zero-padded uniform downscale about the center (NEAREST)
void scale_about_center(const Image& in, double scale, Image* out) {
  int nh = std::max(1, int(in.h * scale + 0.5));
  int nw = std::max(1, int(in.w * scale + 0.5));
  Image small;
  small.h = nh;
  small.w = nw;
  small.c = in.c;
  small.data.resize(size_t(nh) * nw * in.c);
  for (int y = 0; y < nh; y++) {
    int sy = int(int64_t(y) * in.h / nh);
    for (int x = 0; x < nw; x++) {
      int sx = int(int64_t(x) * in.w / nw);
      memcpy(&small.data[(size_t(y) * nw + x) * in.c],
             &in.data[(size_t(sy) * in.w + sx) * in.c], in.c);
    }
  }
  out->h = in.h;
  out->w = in.w;
  out->c = in.c;
  out->data.assign(size_t(in.h) * in.w * in.c, 0);
  int top = (in.h - nh) / 2, left = (in.w - nw) / 2;
  for (int y = 0; y < nh; y++)
    memcpy(&out->data[((size_t(top) + y) * in.w + left) * in.c],
           &small.data[size_t(y) * nw * in.c], size_t(nw) * in.c);
}

struct Example {
  std::vector<uint8_t> image;     // [size, size, 3]
  std::vector<uint8_t> fg_mask;   // [size, size] in {0,1}
  std::vector<uint8_t> aug_mask;  // [size, size] in {0,1}
  int32_t record_idx = 0;
  int32_t ok = 0;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<std::string> mask_paths;  // "" when absent
  int size;
  double flip_p, scale_lo, scale_hi;
  int margin = 12;  // empty-margin shift margin (`personalized.py:654`)
  uint64_t seed;

  std::deque<Example> queue;
  size_t capacity;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> next_idx{0};
  std::vector<std::thread> workers;

  void worker(int wid) {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (wid + 1));
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    while (!stop.load()) {
      uint64_t i = next_idx.fetch_add(1) % paths.size();
      Example ex = make_example(int(i), rng, uni);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < capacity || stop.load(); });
      if (stop.load()) return;
      queue.push_back(std::move(ex));
      cv_pop.notify_one();
    }
  }

  Example make_example(int idx, std::mt19937_64& rng,
                       std::uniform_real_distribution<double>& uni) {
    Example ex;
    ex.record_idx = idx;
    Image img;
    if (!decode(paths[idx], &img) || img.c != 3) return ex;
    Image mask;
    bool has_mask = !mask_paths[idx].empty() &&
                    decode(mask_paths[idx], &mask, /*gray=*/true);
    if (!has_mask) {
      mask.h = img.h;
      mask.w = img.w;
      mask.c = 1;
      mask.data.assign(size_t(img.h) * img.w, 255);
    }
    // stack image+mask so ONE resample moves both (`:574-600`)
    Image stack;
    stack.h = img.h;
    stack.w = img.w;
    stack.c = 4;
    stack.data.resize(size_t(img.h) * img.w * 4);
    // mask may differ in size from the image; nearest-sample it
    for (int y = 0; y < img.h; y++) {
      int my = int(int64_t(y) * mask.h / img.h);
      for (int x = 0; x < img.w; x++) {
        int mx = int(int64_t(x) * mask.w / img.w);
        uint8_t* dst = &stack.data[(size_t(y) * img.w + x) * 4];
        memcpy(dst, &img.data[(size_t(y) * img.w + x) * 3], 3);
        dst[3] = mask.data[size_t(my) * mask.w + mx];
      }
    }
    Image resized;
    nearest_resize(stack, size, &resized);
    if (uni(rng) < flip_p) hflip(&resized);

    std::vector<uint8_t> aug(size_t(size) * size, 1);
    if (scale_hi > 0) {
      // append the aug channel, scale, then margin-shift (`:620-676`)
      Image ext;
      ext.h = ext.w = size;
      ext.c = 5;
      ext.data.resize(size_t(size) * size * 5);
      for (size_t p = 0; p < size_t(size) * size; p++) {
        memcpy(&ext.data[p * 5], &resized.data[p * 4], 4);
        ext.data[p * 5 + 4] = 1;
      }
      double sc = scale_lo + (scale_hi - scale_lo) * uni(rng);
      Image scaled;
      scale_about_center(ext, sc, &scaled);
      // empty margins of the aug channel
      int top0 = 0, bottom0 = 0, left0 = 0, right0 = 0;
      auto row_empty = [&](int y) {
        for (int x = 0; x < size; x++)
          if (scaled.data[(size_t(y) * size + x) * 5 + 4]) return false;
        return true;
      };
      auto col_empty = [&](int x) {
        for (int y = 0; y < size; y++)
          if (scaled.data[(size_t(y) * size + x) * 5 + 4]) return false;
        return true;
      };
      while (top0 < size && row_empty(top0)) top0++;
      while (bottom0 < size - top0 && row_empty(size - 1 - bottom0)) bottom0++;
      while (left0 < size && col_empty(left0)) left0++;
      while (right0 < size - left0 && col_empty(size - 1 - right0)) right0++;
      int dy = 0, dx = 0;
      if (top0 + bottom0 > 2 * margin) {
        dy = int(rng() % uint64_t(top0 + bottom0 - 2 * margin + 1));
        if (dy > bottom0 - margin) dy = -(dy - bottom0 + margin);
      }
      if (left0 + right0 > 2 * margin) {
        dx = int(rng() % uint64_t(left0 + right0 - 2 * margin + 1));
        if (dx > right0 - margin) dx = -(dx - right0 + margin);
      }
      auto wrap = [&](int v) { return ((v % size) + size) % size; };
      ex.image.resize(size_t(size) * size * 3);
      ex.fg_mask.resize(size_t(size) * size);
      ex.aug_mask.resize(size_t(size) * size);
      for (int y = 0; y < size; y++) {
        int sy = wrap(y - dy);
        for (int x = 0; x < size; x++) {
          int sx = wrap(x - dx);
          const uint8_t* src = &scaled.data[(size_t(sy) * size + sx) * 5];
          uint8_t* dst = &ex.image[(size_t(y) * size + x) * 3];
          memcpy(dst, src, 3);
          ex.fg_mask[size_t(y) * size + x] = src[3] > 127 ? 1 : 0;
          ex.aug_mask[size_t(y) * size + x] = src[4];
        }
      }
    } else {
      ex.image.resize(size_t(size) * size * 3);
      ex.fg_mask.resize(size_t(size) * size);
      for (size_t p = 0; p < size_t(size) * size; p++) {
        memcpy(&ex.image[p * 3], &resized.data[p * 4], 3);
        ex.fg_mask[p] = resized.data[p * 4 + 3] > 127 ? 1 : 0;
      }
      ex.aug_mask = aug;
    }
    ex.ok = 1;
    return ex;
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, const char** mask_paths, int n,
                    int size, double flip_p, double scale_lo, double scale_hi,
                    uint64_t seed, int n_workers, int queue_capacity) {
  auto* L = new Loader();
  for (int i = 0; i < n; i++) {
    L->paths.emplace_back(paths[i]);
    L->mask_paths.emplace_back(mask_paths[i] ? mask_paths[i] : "");
  }
  L->size = size;
  L->flip_p = flip_p;
  L->scale_lo = scale_lo;
  L->scale_hi = scale_hi;
  L->seed = seed;
  L->capacity = queue_capacity > 0 ? queue_capacity : 8;
  int nw = n_workers > 0 ? n_workers : 2;
  for (int w = 0; w < nw; w++)
    L->workers.emplace_back(&Loader::worker, L, w);
  return L;
}

// Blocking pop. Returns the record index, or -1 on decode failure.
int loader_next(void* handle, uint8_t* image, uint8_t* fg_mask,
                uint8_t* aug_mask) {
  auto* L = static_cast<Loader*>(handle);
  Example ex;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->stop.load(); });
    if (L->stop.load() && L->queue.empty()) return -2;
    ex = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_push.notify_one();
  }
  if (!ex.ok) return -1;
  memcpy(image, ex.image.data(), ex.image.size());
  memcpy(fg_mask, ex.fg_mask.data(), ex.fg_mask.size());
  memcpy(aug_mask, ex.aug_mask.data(), ex.aug_mask.size());
  return ex.record_idx;
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
