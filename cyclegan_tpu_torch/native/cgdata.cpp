// cgdata: native host-side image preprocessing for the input pipeline of
// cyclegan_tpu_torch (the port's own copy of the JAX package's
// cyclegan_tpu/native/cgdata.cpp, with the same arithmetic, so that both
// packages' native paths give the same bytes).
//
// The fused op is resize (bilinear, half-pixel centres) -> flip -> crop ->
// normalise ([-1, 1]) or round to uint8, in one pass per image, with a
// std::thread pool over a batch. The Python side draws the random
// decisions (flip, crop offsets), so the numpy and native paths take the
// same ones.
//
// Built as a plain shared library (g++ -O3 -shared -fPIC -pthread) at first
// use by cyclegan_tpu_torch/data/native.py and bound with ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <thread>
#include <vector>

namespace {

// Bilinear sample row/col helper: TF2 half-pixel-center convention.
struct Coord {
  int i0, i1;
  float frac;
};

static inline Coord coord(int out_i, int in_n, float scale) {
  float c = (static_cast<float>(out_i) + 0.5f) * scale - 0.5f;
  float lo = std::floor(c);
  Coord r;
  r.frac = c - lo;
  int i0 = static_cast<int>(lo);
  r.i0 = std::min(std::max(i0, 0), in_n - 1);
  r.i1 = std::min(std::max(i0 + 1, 0), in_n - 1);
  return r;
}

// Output policies: float32 normalized to [-1, 1] (feeding the device
// directly), or uint8 rounded half-even (the 4x-smaller cache format —
// the pipeline normalizes on batch assembly).
static inline void store_px(float v, float* o) {
  constexpr float kInv = 1.0f / 127.5f;
  // clamp: bilinear of uint8 is within [0,255] mathematically, but
  // float32 rounding can spill a ulp past +/-1 after normalizing
  *o = std::min(1.0f, std::max(-1.0f, v * kInv - 1.0f));
}

static inline void store_px(float v, uint8_t* o) {
  // std::nearbyint rounds half-even in the default FP environment,
  // matching numpy's np.rint in the numpy path (data/augment.py).
  *o = static_cast<uint8_t>(
      std::nearbyint(std::min(255.0f, std::max(0.0f, v))));
}

// Fused: uint8 [h, w, 3] -> resize to [rh, rw] -> optional horizontal
// flip (applied BEFORE resize, matching the reference op order
// main.py:40-44) -> crop [crop, crop] at (oy, ox) -> OutT (see store_px).
template <typename OutT>
void preprocess_one(const uint8_t* img, int h, int w,
                    int rh, int rw, int flip, int oy, int ox, int crop,
                    OutT* out) {
  const float sy = static_cast<float>(h) / rh;
  const float sx = static_cast<float>(w) / rw;
  // Precompute x-coords for the cropped window only.
  std::vector<Coord> xs(crop);
  for (int j = 0; j < crop; ++j) {
    Coord cx = coord(ox + j, w, sx);
    if (flip) {  // sampling a flipped image == mirrored source columns
      cx.i0 = w - 1 - cx.i0;
      cx.i1 = w - 1 - cx.i1;
    }
    xs[j] = cx;
  }
  for (int i = 0; i < crop; ++i) {
    const Coord cy = coord(oy + i, h, sy);
    const uint8_t* row0 = img + static_cast<size_t>(cy.i0) * w * 3;
    const uint8_t* row1 = img + static_cast<size_t>(cy.i1) * w * 3;
    const float fy = cy.frac;
    OutT* orow = out + static_cast<size_t>(i) * crop * 3;
    for (int j = 0; j < crop; ++j) {
      const Coord& cx = xs[j];
      const float fx = cx.frac;
      const uint8_t* p00 = row0 + cx.i0 * 3;
      const uint8_t* p01 = row0 + cx.i1 * 3;
      const uint8_t* p10 = row1 + cx.i0 * 3;
      const uint8_t* p11 = row1 + cx.i1 * 3;
      for (int ch = 0; ch < 3; ++ch) {
        const float top = p00[ch] + (p01[ch] - static_cast<float>(p00[ch])) * fx;
        const float bot = p10[ch] + (p11[ch] - static_cast<float>(p10[ch])) * fx;
        const float v = top + (bot - top) * fy;
        store_px(v, orow + j * 3 + ch);
      }
    }
  }
}

template <typename OutT>
void preprocess_batch(const uint8_t* imgs, int n, int h, int w,
                      int rh, int rw,
                      const int* flips, const int* oys, const int* oxs,
                      int crop, OutT* out, int n_threads) {
  if (n_threads < 1) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
  }
  n_threads = std::min(n_threads, n);
  const size_t in_stride = static_cast<size_t>(h) * w * 3;
  const size_t out_stride = static_cast<size_t>(crop) * crop * 3;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int i = t; i < n; i += n_threads) {
        preprocess_one(imgs + i * in_stride, h, w, rh, rw,
                       flips[i], oys[i], oxs[i], crop, out + i * out_stride);
      }
    });
  }
  for (auto& th : workers) th.join();
}

}  // namespace

extern "C" {

// Single image, float32 [-1, 1] output (see preprocess_one).
void cg_preprocess(const uint8_t* img, int h, int w,
                   int rh, int rw, int flip, int oy, int ox, int crop,
                   float* out) {
  preprocess_one(img, h, w, rh, rw, flip, oy, ox, crop, out);
}

// Single image, uint8 output (cache format; no normalize).
void cg_preprocess_u8(const uint8_t* img, int h, int w,
                      int rh, int rw, int flip, int oy, int ox, int crop,
                      uint8_t* out) {
  preprocess_one(img, h, w, rh, rw, flip, oy, ox, crop, out);
}

// Batch of same-sized images, threaded. imgs: [n, h, w, 3] contiguous;
// flips/oys/oxs: per-image params; out: [n, crop, crop, 3].
void cg_preprocess_batch(const uint8_t* imgs, int n, int h, int w,
                         int rh, int rw,
                         const int* flips, const int* oys, const int* oxs,
                         int crop, float* out, int n_threads) {
  preprocess_batch(imgs, n, h, w, rh, rw, flips, oys, oxs, crop, out,
                   n_threads);
}

// Batch, uint8 output (cache format; no normalize).
void cg_preprocess_batch_u8(const uint8_t* imgs, int n, int h, int w,
                            int rh, int rw,
                            const int* flips, const int* oys, const int* oxs,
                            int crop, uint8_t* out, int n_threads) {
  preprocess_batch(imgs, n, h, w, rh, rw, flips, oys, oxs, crop, out,
                   n_threads);
}

int cg_version() { return 2; }

}  // extern "C"
