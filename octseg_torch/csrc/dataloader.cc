// Multi-threaded training data loader, on the host.
//
// A copy of octseg's native loader (the default training path of
// configs/train.yaml, native_loader: auto): a thread pool decodes PNG images
// (its own decoder on zlib's inflate) and LZW mask TIFFs
// (octseg_lzw_decode from lzw.cc), resizes them with cv2's conventions
// (INTER_LINEAR half-pixel for images, float bilinear without cv2's
// fixed-point rounding; INTER_NEAREST floor for masks), binarizes the
// selected class channels and hands batches to Python
// (octseg_torch/train/native_loader.py) through the C interface below.
//
// One change from octseg: batches are handed out in index order. octseg's
// workers claim batch indices in order but queue finished batches in the
// order they complete, so with several workers the order of an epoch varies
// from run to run. Here a finished batch goes into the slot of its index,
// and octseg_loader_next waits for the slot of the next index; the result
// is what octseg gives with one worker. A worker may store a decoded batch
// only while its index is below next_out + max_queue, which bounds memory
// and cannot deadlock: the worker that holds the next index can always
// store it.
//
// Built with -ffp-contract=off (ops/kernels/_build.py), so the bilinear
// sums are not contracted into FMAs and give the same floats on any x86-64.
//
// Exported C interface:
//   octseg_loader_create(paths, ...)  -> handle
//   octseg_loader_next(handle, imgs_out, masks_out) -> frames filled (0 = end)
//   octseg_loader_reset(handle, epoch_seed)
//   octseg_loader_destroy(handle)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
// no development headers: zlib's one entry point used here, resolved from
// the runtime library libz.so.1 at link time
extern "C" {
typedef unsigned long uLongf;
int uncompress(unsigned char* dest, uLongf* destLen, const unsigned char* source,
               unsigned long sourceLen);
}
#define Z_OK 0
#endif

extern "C" int64_t octseg_lzw_decode(const uint8_t* src, int64_t n,
                                     uint8_t* dst, int64_t cap);

namespace {

// ---------------------------------------------------------------- PNG ----

bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  const auto size = f.tellg();
  out->resize(static_cast<size_t>(size));
  f.seekg(0);
  f.read(reinterpret_cast<char*>(out->data()), size);
  return bool(f);
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit non-interlaced PNG (gray / RGB / RGBA / gray+alpha) into
// HWC uint8 with `want_channels` (3) output, BGR order to match cv2.imread.
bool decode_png_bgr(const std::vector<uint8_t>& file, std::vector<uint8_t>* out,
                    int* out_h, int* out_w) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 8 || std::memcmp(file.data(), magic, 8) != 0) return false;
  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= file.size()) {
    const uint32_t len = be32(&file[pos]);
    const char* type = reinterpret_cast<const char*>(&file[pos + 4]);
    const uint8_t* data = &file[pos + 8];
    if (pos + 12 + len > file.size()) return false;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      width = be32(data);
      height = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (bit_depth != 8 || interlace != 0 || width == 0 || height == 0) return false;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return false;
  }
  const size_t stride = size_t(width) * ch;
  std::vector<uint8_t> raw(height * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return false;
  }
  // unfilter in place into `img`
  std::vector<uint8_t> img(height * stride);
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &img[y * stride];
    const uint8_t* up = y ? &img[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      const int a = x >= size_t(ch) ? dst[x - ch] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= size_t(ch)) ? up[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }
  // convert to BGR 3-channel
  out->resize(size_t(height) * width * 3);
  for (size_t i = 0; i < size_t(height) * width; ++i) {
    uint8_t r, g, b;
    if (ch == 1 || ch == 2) {
      r = g = b = img[i * ch];
    } else {
      r = img[i * ch];
      g = img[i * ch + 1];
      b = img[i * ch + 2];
    }
    (*out)[i * 3 + 0] = b;
    (*out)[i * 3 + 1] = g;
    (*out)[i * 3 + 2] = r;
  }
  *out_h = int(height);
  *out_w = int(width);
  return true;
}

// ---------------------------------------------------------------- TIFF ----

struct TiffInfo {
  int h = 0, w = 0, spp = 1;
  std::vector<uint8_t> data;  // HWC uint8
};

uint16_t rd16(const uint8_t* p, bool le) {
  return le ? uint16_t(p[0] | (p[1] << 8)) : uint16_t((p[0] << 8) | p[1]);
}
uint32_t rd32(const uint8_t* p, bool le) {
  return le ? (uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
               (uint32_t(p[3]) << 24))
            : be32(p);
}

// Minimal strip-based uint8 TIFF reader (compression: none/LZW), matching
// the subset octseg.data.tiffio writes/reads.
bool decode_tiff(const std::vector<uint8_t>& f, TiffInfo* info) {
  if (f.size() < 8) return false;
  const bool le = f[0] == 'I';
  if ((le && f[1] != 'I') || (!le && f[0] != 'M')) return false;
  uint32_t ifd = rd32(&f[4], le);
  if (ifd + 2 > f.size()) return false;
  const int n = rd16(&f[ifd], le);
  uint32_t width = 0, height = 0, comp = 1, spp = 1, rows_per_strip = 0;
  std::vector<uint32_t> offsets, counts;
  static const size_t type_size[] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};

  for (int i = 0; i < n; ++i) {
    const uint8_t* e = &f[ifd + 2 + i * 12];
    const uint16_t tag = rd16(e, le);
    const uint16_t typ = rd16(e + 2, le);
    const uint32_t cnt = rd32(e + 4, le);
    const size_t sz = (typ < 13 ? type_size[typ] : 1) * cnt;
    const uint8_t* val = sz <= 4 ? e + 8 : &f[rd32(e + 8, le)];
    auto geti = [&](uint32_t k) -> uint32_t {
      return typ == 3 ? rd16(val + 2 * k, le) : rd32(val + 4 * k, le);
    };
    switch (tag) {
      case 256: width = geti(0); break;
      case 257: height = geti(0); break;
      case 259: comp = geti(0); break;
      case 277: spp = geti(0); break;
      case 278: rows_per_strip = geti(0); break;
      case 273: for (uint32_t k = 0; k < cnt; ++k) offsets.push_back(geti(k)); break;
      case 279: for (uint32_t k = 0; k < cnt; ++k) counts.push_back(geti(k)); break;
      default: break;
    }
  }
  if (!width || !height || offsets.empty()) return false;
  if (!rows_per_strip) rows_per_strip = height;
  const size_t total = size_t(width) * height * spp;
  info->data.resize(total);
  size_t written = 0;
  for (size_t s = 0; s < offsets.size(); ++s) {
    const size_t want = std::min(size_t(rows_per_strip) * width * spp,
                                 total - written);
    if (comp == 1) {
      std::memcpy(&info->data[written], &f[offsets[s]], want);
      written += want;
    } else if (comp == 5) {
      const int64_t got = octseg_lzw_decode(&f[offsets[s]], counts[s],
                                            &info->data[written], want);
      if (got < 0) return false;
      written += size_t(got);
    } else {
      return false;
    }
  }
  info->h = int(height);
  info->w = int(width);
  info->spp = int(spp);
  return true;
}

// -------------------------------------------------------------- resize ----

// cv2.INTER_LINEAR (half-pixel centers) uint8 HWC -> float32 HWC.
void resize_bilinear(const uint8_t* src, int sh, int sw, int ch, float* dst,
                     int dh, int dw) {
  const float sy = float(sh) / dh, sx = float(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.f, std::min(fy, float(sh - 1)));
    const int y0 = int(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.f, std::min(fx, float(sw - 1)));
      const int x0 = int(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      for (int c = 0; c < ch; ++c) {
        const float v00 = src[(y0 * sw + x0) * ch + c];
        const float v01 = src[(y0 * sw + x1) * ch + c];
        const float v10 = src[(y1 * sw + x0) * ch + c];
        const float v11 = src[(y1 * sw + x1) * ch + c];
        dst[(y * dw + x) * ch + c] =
            v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx;
      }
    }
  }
}

// cv2.INTER_NEAREST (floor) channel-select + binarize mask resize.
void resize_nearest_mask(const uint8_t* src, int sh, int sw, int spp,
                         const int* channels, int n_ch, float* dst, int dh,
                         int dw) {
  const float sy = float(sh) / dh, sx = float(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    const int yy = std::min(int(y * sy), sh - 1);
    for (int x = 0; x < dw; ++x) {
      const int xx = std::min(int(x * sx), sw - 1);
      for (int c = 0; c < n_ch; ++c) {
        const uint8_t v = src[(yy * sw + xx) * spp + channels[c]];
        dst[(y * dw + x) * n_ch + c] = v > 0 ? 1.f : 0.f;
      }
    }
  }
}

// -------------------------------------------------------------- loader ----

struct Batch {
  std::vector<float> imgs;
  std::vector<float> masks;
  int count = 0;
};

struct Loader {
  std::vector<std::string> img_paths, mask_paths;
  int input_size, n_classes, batch_size, n_threads;
  std::vector<int> channels;
  bool shuffle;
  unsigned seed;

  std::vector<size_t> order;
  std::atomic<size_t> next_batch_idx{0};
  size_t n_batches = 0;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<size_t, Batch> ready;  // finished batches by index
  size_t next_out = 0;            // index of the next batch to hand out
  size_t max_queue = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stopping{false};
  std::atomic<int> active_workers{0};

  void build_order(unsigned epoch_seed) {
    order.resize(img_paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    if (shuffle) {
      std::mt19937 rng(seed + epoch_seed);
      std::shuffle(order.begin(), order.end(), rng);
    }
    n_batches = order.size() / batch_size;  // drop_last
    next_batch_idx = 0;
    next_out = 0;
  }

  bool load_sample(size_t idx, float* img_out, float* mask_out) {
    std::vector<uint8_t> file;
    if (!read_file(img_paths[idx], &file)) return false;
    std::vector<uint8_t> rgb;
    int h, w;
    if (!decode_png_bgr(file, &rgb, &h, &w)) return false;
    resize_bilinear(rgb.data(), h, w, 3, img_out, input_size, input_size);

    if (!read_file(mask_paths[idx], &file)) return false;
    TiffInfo tiff;
    if (!decode_tiff(file, &tiff)) return false;
    resize_nearest_mask(tiff.data.data(), tiff.h, tiff.w, tiff.spp,
                        channels.data(), n_classes, mask_out, input_size,
                        input_size);
    return true;
  }

  void worker() {
    const size_t img_elems = size_t(input_size) * input_size * 3;
    const size_t mask_elems = size_t(input_size) * input_size * n_classes;
    while (!stopping) {
      const size_t b = next_batch_idx.fetch_add(1);
      if (b >= n_batches) break;
      Batch batch;
      batch.imgs.resize(size_t(batch_size) * img_elems);
      batch.masks.resize(size_t(batch_size) * mask_elems);
      batch.count = batch_size;
      for (int i = 0; i < batch_size; ++i) {
        const size_t idx = order[b * batch_size + i];
        if (!load_sample(idx, &batch.imgs[i * img_elems],
                         &batch.masks[i * mask_elems])) {
          batch.count = -1;  // poisoned batch signals a decode error
          break;
        }
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_space.wait(lock, [&] { return b < next_out + max_queue || stopping; });
      if (stopping) break;
      ready.emplace(b, std::move(batch));
      cv_ready.notify_all();
    }
    if (--active_workers == 0) {
      std::lock_guard<std::mutex> lock(mu);
      cv_ready.notify_all();
    }
  }

  void start() {
    stopping = false;
    active_workers = n_threads;
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { worker(); });
    }
  }

  void stop() {
    {
      // the flag must flip under mu: a worker that already evaluated the
      // cv_space predicate (under mu) but has not yet blocked would miss a
      // bare notify — lost wakeup, and join() below hangs forever
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
    workers.clear();
    ready.clear();
  }
};

}  // namespace

extern "C" {

void* octseg_loader_create(const char** img_paths, const char** mask_paths,
                           int n, int input_size, int n_classes,
                           const int* class_channels, int batch_size,
                           int n_threads, int shuffle, unsigned seed) {
  auto* loader = new Loader();
  loader->img_paths.assign(img_paths, img_paths + n);
  loader->mask_paths.assign(mask_paths, mask_paths + n);
  loader->input_size = input_size;
  loader->n_classes = n_classes;
  loader->channels.assign(class_channels, class_channels + n_classes);
  loader->batch_size = batch_size;
  loader->n_threads = std::max(1, n_threads);
  loader->shuffle = shuffle != 0;
  loader->seed = seed;
  loader->build_order(0);
  loader->start();
  return loader;
}

// Returns frames copied into imgs_out/masks_out, batches in index order; 0
// at epoch end, -1 on a decode error.
int octseg_loader_next(void* handle, float* imgs_out, float* masks_out) {
  auto* loader = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(loader->mu);
  loader->cv_ready.wait(lock, [&] {
    return loader->ready.count(loader->next_out) != 0 ||
           loader->active_workers == 0;
  });
  auto it = loader->ready.find(loader->next_out);
  if (it == loader->ready.end()) return 0;
  Batch batch = std::move(it->second);
  loader->ready.erase(it);
  ++loader->next_out;
  loader->cv_space.notify_all();
  lock.unlock();
  if (batch.count < 0) return -1;
  std::memcpy(imgs_out, batch.imgs.data(), batch.imgs.size() * sizeof(float));
  std::memcpy(masks_out, batch.masks.data(),
              batch.masks.size() * sizeof(float));
  return batch.count;
}

void octseg_loader_reset(void* handle, unsigned epoch_seed) {
  auto* loader = static_cast<Loader*>(handle);
  loader->stop();
  loader->build_order(epoch_seed);
  loader->start();
}

void octseg_loader_destroy(void* handle) {
  auto* loader = static_cast<Loader*>(handle);
  loader->stop();
  delete loader;
}

}  // extern "C"
