// The norm -> LeakyReLU(slope) -> tf-REFLECT pad(p) apply pass (f32, NHWC)
// on its own, for statistics computed elsewhere: the tail of the upsample
// kernels K5 and K6 (upsample.cu), whose GEMM reduces the norm statistics
// in its epilogue. (K1 and K3 apply from shared memory inside their own
// one launch, instance_norm.cu.)
//
// Bound: bytes. The pre-norm input read once (a border pixel is read
// again by each place it is mirrored to, from L2) and the padded output
// written once. At the generator's second upsample ([1, 256, 256, 64],
// pad 3) that is 34 MB, 10.3 us at 3.35 TB/s.
//
// Design: the grid is shaped to the output. Block (i, j) takes padded row
// i of the batch (one division by H+2p a block) and kPixels * blockDim.y
// of its columns; its threads are blockDim.x lanes of kVec channels
// (16-byte loads and stores along C where C % 4 == 0 and x and y are
// 16-byte aligned, else 4-byte ones) times blockDim.y pixels. Each pixel's
// mirrored source (src = r - p, then -src if below 0, then 2(H-1) - src if
// at or past H; the border is not repeated) is found once, with no
// division, and a lane loads its channels' statistics and parameters once
// for all its pixels.
#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 4;  // pixels a thread, at a stride of blockDim.y

__device__ __forceinline__ int reflect_index(int i, int size) {
  if (i < 0) i = -i;
  if (i >= size) i = 2 * (size - 1) - i;
  return i;
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
norm_act_pad_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int h, int w, int c, int pad, float slope) {
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const int n = blockIdx.x / hp, out_row = blockIdx.x - n * hp;
  const int src_row = reflect_index(out_row - pad, h);
  const float* xr = x + ((size_t)n * h + src_row) * w * c;
  float* yr = y + (size_t)blockIdx.x * wp * c;
  const int col0 = blockIdx.y * kPixels * blockDim.y + threadIdx.y;
  for (int ch = threadIdx.x * kVec; ch < c; ch += blockDim.x * kVec) {
    Pack<kVec> mu, iv, sc, bi;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mu.v[j] = __ldg(mean + (size_t)n * c + ch + j);
      iv.v[j] = __ldg(inv + (size_t)n * c + ch + j);
      sc.v[j] = __ldg(scale + ch + j);
      bi.v[j] = __ldg(bias + ch + j);
    }
    Pack<kVec> v[kPixels];
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      const int col = col0 + k * blockDim.y;
      if (col < wp) {
        v[k] = load<kVec>(xr + (size_t)reflect_index(col - pad, w) * c + ch);
      }
    }
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      const int col = col0 + k * blockDim.y;
      if (col >= wp) continue;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float t = (v[k].v[j] - mu.v[j]) * iv.v[j] * sc.v[j] + bi.v[j];
        // max(t, 0) + slope * min(t, 0) for 0 <= slope <= 1, written so
        // that slope 1 is exactly the identity and a NaN stays a NaN.
        v[k].v[j] = t > 0.f ? t : slope * t;
      }
      store<kVec>(yr + (size_t)col * c + ch, v[k]);
    }
  }
}

}  // namespace

cudaError_t launch_norm_act_pad(const float* x, const float* mean,
                                const float* inv, const float* scale,
                                const float* bias, float* y, int n, int h,
                                int w, int c, int pad, float slope,
                                cudaStream_t stream) {
  const bool aligned = reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(y) % 16 == 0;
  const int vec = c % 4 == 0 && aligned ? 4 : 1;
  // Lanes across C (at most a warp), pixels down the block.
  const int lanes = c / vec < 32 ? c / vec : 32;
  const int pixels = kThreads / lanes;
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const long long rows = (long long)n * hp;
  const int col_blocks = (wp + kPixels * pixels - 1) / (kPixels * pixels);
  if (pad < 0 || pad >= h || pad >= w || rows >= (1LL << 31) ||
      col_blocks > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)rows, col_blocks), block(lanes, pixels);
  if (vec == 4) {
    norm_act_pad_kernel<4><<<grid, block, 0, stream>>>(
        x, mean, inv, scale, bias, y, h, w, c, pad, slope);
  } else {
    norm_act_pad_kernel<1><<<grid, block, 0, stream>>>(
        x, mean, inv, scale, bias, y, h, w, c, pad, slope);
  }
  return cudaGetLastError();
}

}  // namespace cg
