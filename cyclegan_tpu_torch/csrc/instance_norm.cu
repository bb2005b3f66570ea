// Instance norm forward (f32, NHWC) for Hopper.
//
// Replaces the TPU kernel cyclegan_tpu/ops/pallas/norm_kernel.py:_forward
// (pallas_call at :100): per-(n, c) mean and biased variance over H*W,
// y = (x - mean) * rsqrt(var + eps) * scale + bias, with mean and inv
// written out as [N, C].
//
// Bound: bytes. Each element is read twice (statistics, apply) and
// written once, with a few operations each, far below the card's
// operations-per-byte balance.
//
// Design: the TPU kernel keeps one (sample, 128-channel) slab resident
// and reduces it in one grid step. Here that gives only N * C / 128
// blocks for 132 SMs, so the statistics are split over chunks of H*W
// rows: a block of 32 channels x 8 row lanes reads rows with one warp on
// 32 neighbouring channels (128 coalesced bytes), keeps a Welford
// (count, mean, M2) per thread, and merges lanes and then chunks with
// Chan's formula. That matches the TPU kernel's two-pass centred
// variance; E[x^2] - E[x]^2 would cancel on conv outputs with a large
// mean. The apply pass is the epilogue's (epilogue.cu) with no pad and
// slope 1.
#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kLanesC = 32;  // channels per statistics block (one warp)
constexpr int kLanesR = 8;   // row lanes per statistics block
constexpr int kThreads = 256;

// Merge moments (nb, mb, m2b) into (na, ma, m2a): Chan et al.
__device__ __forceinline__ void merge(float& na, float& ma, float& m2a,
                                      float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float total = na + nb;
  const float delta = mb - ma;
  const float fb = nb / total;
  ma += delta * fb;
  m2a += m2b + delta * delta * na * fb;
  na = total;
}

// One Welford step: fold value v into (cnt, mean, m2).
__device__ __forceinline__ void welford(float& cnt, float& mean, float& m2,
                                        float v) {
  cnt += 1.f;
  const float d = v - mean;
  mean += d / cnt;
  m2 += d * (v - mean);
}

__global__ void __launch_bounds__(kLanesC * kLanesR)
stats_partial_kernel(const float* __restrict__ x, int hw, int c,
                     int chunk_rows, int chunks,
                     float* __restrict__ part_mean,
                     float* __restrict__ part_m2) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.y * kLanesC + tx;
  const int chunk = blockIdx.x;
  const int n = blockIdx.z;
  const int row0 = chunk * chunk_rows;
  const int row1 = min(row0 + chunk_rows, hw);
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  if (ch < c) {
    const float* base = x + (size_t)n * hw * c + ch;
    int r = row0 + ty;
    // Four independent loads in flight before the dependent updates.
    for (; r + 3 * kLanesR < row1; r += 4 * kLanesR) {
      const float v0 = base[(size_t)r * c];
      const float v1 = base[(size_t)(r + kLanesR) * c];
      const float v2 = base[(size_t)(r + 2 * kLanesR) * c];
      const float v3 = base[(size_t)(r + 3 * kLanesR) * c];
      welford(cnt, mean, m2, v0);
      welford(cnt, mean, m2, v1);
      welford(cnt, mean, m2, v2);
      welford(cnt, mean, m2, v3);
    }
    for (; r < row1; r += kLanesR) welford(cnt, mean, m2, base[(size_t)r * c]);
  }
  __shared__ float s_cnt[kLanesR][kLanesC];
  __shared__ float s_mean[kLanesR][kLanesC];
  __shared__ float s_m2[kLanesR][kLanesC];
  s_cnt[ty][tx] = cnt;
  s_mean[ty][tx] = mean;
  s_m2[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && ch < c) {
    for (int i = 1; i < kLanesR; ++i) {
      merge(cnt, mean, m2, s_cnt[i][tx], s_mean[i][tx], s_m2[i][tx]);
    }
    const size_t o = ((size_t)n * chunks + chunk) * c + ch;
    part_mean[o] = mean;
    part_m2[o] = m2;
  }
}

// One warp per (n, c): lanes merge every 32nd chunk, then the lanes merge
// with each other through shuffles.
__global__ void stats_finalize_kernel(const float* __restrict__ part_mean,
                                      const float* __restrict__ part_m2,
                                      int n_total, int hw, int c,
                                      int chunk_rows, int chunks, float eps,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ inv_out) {
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= n_total * c) return;  // uniform across the warp
  const int n = idx / c, ch = idx % c;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (int s = lane; s < chunks; s += 32) {
    const size_t o = ((size_t)n * chunks + s) * c + ch;
    const float rows = (float)min(chunk_rows, hw - s * chunk_rows);
    merge(cnt, mean, m2, rows, part_mean[o], part_m2[o]);
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cnt, offset);
    const float mb = __shfl_down_sync(0xffffffffu, mean, offset);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, offset);
    merge(cnt, mean, m2, nb, mb, m2b);
  }
  if (lane == 0) {
    mean_out[idx] = mean;
    inv_out[idx] = 1.0f / sqrtf(m2 / (float)hw + eps);
  }
}

}  // namespace

cudaError_t launch_instance_stats(const float* x, int n, int hw, int c,
                                  int chunk_rows, int chunks,
                                  float* part_mean, float* part_m2,
                                  float* mean, float* inv, float eps,
                                  cudaStream_t stream) {
  const dim3 block(kLanesC, kLanesR);
  const dim3 grid(chunks, (c + kLanesC - 1) / kLanesC, n);
  stats_partial_kernel<<<grid, block, 0, stream>>>(x, hw, c, chunk_rows,
                                                   chunks, part_mean, part_m2);
  const int finalize_blocks = (int)((32LL * n * c + kThreads - 1) / kThreads);
  stats_finalize_kernel<<<finalize_blocks, kThreads, 0, stream>>>(
      part_mean, part_m2, n, hw, c, chunk_rows, chunks, eps, mean, inv);
  return cudaGetLastError();
}

}  // namespace cg

extern "C" int cg_instance_norm_forward(const float* x, const float* scale,
                                        const float* bias, float* y,
                                        float* part_mean, float* part_m2,
                                        float* mean, float* inv, int n,
                                        int hw, int c, float eps,
                                        int chunk_rows, int chunks,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cg::launch_instance_stats(
      x, n, hw, c, chunk_rows, chunks, part_mean, part_m2, mean, inv, eps, s);
  if (err != cudaSuccess) return (int)err;
  // The epilogue's apply pass with no pad and slope 1 (the identity), over
  // x viewed as [N, HW, 1, C].
  return (int)cg::launch_norm_act_pad(x, mean, inv, scale, bias, y, n, hw, 1,
                                      c, 0, 1.0f, s);
}

extern "C" const char* cg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
