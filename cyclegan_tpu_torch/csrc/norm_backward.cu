// Backward of instance norm (K2) and of the conv epilogue (K4), f32 NHWC,
// for Hopper.
//
// Replaces the TPU kernels cyclegan_tpu/ops/pallas/norm_kernel.py:_backward
// (pallas_call at :154) and cyclegan_tpu/ops/pallas/epilogue_kernel.py:
// _backward (pallas_call at :176). With the forward's saved per-(n, c) mean
// and inv = 1/sqrt(var + eps), and g the cotangent of the forward's output:
//   g1     = fold(g)                    K4: the transpose of the reflect pad
//   g2     = pre > 0 ? g1 : slope * g1  K4: pre = xhat * scale + bias
//   xhat   = (x - mean) * inv
//   dbias  = sum_HW g2                  per (n, c); the caller sums over N
//   dscale = sum_HW g2 * xhat
//   dx     = scale * inv * (g2 - dbias / HW - xhat * dscale / HW)
// K2 is the same with no fold and no mask.
//
// Bound: bytes. x and g are read and dx is written (three activation-sized
// tensors) with about 15 operations per element, far below the card's
// operations-per-byte balance.
//
// Design: the TPU kernels keep a whole (sample, 128-channel) slab resident
// and reduce it in one grid step; at the 256^2 sites that slab is past the
// VMEM budget and the JAX package runs XLA there instead. Here the work is
// two passes over blocks that run in no order. Pass 1 splits H*W into the
// forward's chunks (ops/cuda/norm_kernel.py stats_chunking): a block of 32
// channels x 8 row lanes sums g2 and g2 * xhat over its chunk, and one warp
// per (n, c) then adds the chunks' partials with shuffles. These are plain
// sums, so no Welford merge is needed. Pass 2 is elementwise and writes
// dx. The fold gathers rather than scatters: each interior element adds
// the padded positions that mirror onto it (at most 3 rows x 3 columns),
// so there are no atomics and the sums come out in the same order on every
// run. The activation mask is recomputed from x and the saved statistics,
// so the forward saves nothing more than the plain instance norm does.
#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kLanesC = 32;  // channels per reduction block (one warp)
constexpr int kLanesR = 8;   // row lanes per reduction block
constexpr int kThreads = 256;

// The padded rows (or columns) whose cotangent folds onto interior index i
// of a dimension of `size` under tf-REFLECT pad p: i + p itself; its mirror
// above the border, p - i, for 1 <= i <= p; and its mirror below the
// border, p + 2 * size - 2 - i, for size - 1 - p <= i <= size - 2.
struct Sources {
  int idx[3];
  int count;
};

__device__ __forceinline__ Sources fold_sources(int i, int size, int pad) {
  Sources s;
  s.idx[0] = i + pad;
  s.count = 1;
  if (i >= 1 && i <= pad) s.idx[s.count++] = pad - i;
  if (i >= size - 1 - pad && i <= size - 2) {
    s.idx[s.count++] = pad + 2 * size - 2 - i;
  }
  return s;
}

struct Args {
  const float* x;      // [N, H, W, C]
  const float* g;      // [N, H+2p, W+2p, C]
  const float* mean;   // [N, C]
  const float* inv;    // [N, C]
  const float* scale;  // [C]
  const float* bias;   // [C], read only with the mask
  int h, w, c, pad;
  float slope;
};

// g2 at interior pixel `pix` (= row * W + col) of sample n, channel ch;
// xhat of the same element comes back through `xhat`.
template <bool kFold, bool kMask>
__device__ __forceinline__ float masked_cotangent(const Args& a, int n,
                                                  int pix, int ch,
                                                  float mean, float inv,
                                                  float scale, float bias,
                                                  float& xhat) {
  const size_t hw = (size_t)a.h * a.w;
  // Rounded op by op, as the plain version computes them, so that the mask
  // below picks the same side of 0 (no fused multiply-add here).
  xhat = __fmul_rn(__fsub_rn(a.x[((size_t)n * hw + pix) * a.c + ch], mean),
                   inv);
  float gv;
  if (kFold) {
    const int wp = a.w + 2 * a.pad;
    const float* gn = a.g + (size_t)n * (a.h + 2 * a.pad) * wp * a.c + ch;
    const Sources rows = fold_sources(pix / a.w, a.h, a.pad);
    const Sources cols = fold_sources(pix % a.w, a.w, a.pad);
    gv = 0.f;
    for (int i = 0; i < rows.count; ++i) {
      for (int j = 0; j < cols.count; ++j) {
        gv += gn[((size_t)rows.idx[i] * wp + cols.idx[j]) * a.c];
      }
    }
  } else {
    gv = a.g[((size_t)n * hw + pix) * a.c + ch];
  }
  if (kMask) {
    // jnp.where(pre > 0, g, slope * g): pre == 0 takes the slope branch.
    gv = __fadd_rn(__fmul_rn(xhat, scale), bias) > 0.f ? gv : a.slope * gv;
  }
  return gv;
}

template <bool kFold, bool kMask>
__global__ void __launch_bounds__(kLanesC * kLanesR)
bwd_partial_kernel(Args a, int chunk_rows, int chunks,
                   float* __restrict__ part_g, float* __restrict__ part_gx) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.y * kLanesC + tx;
  const int chunk = blockIdx.x;
  const int n = blockIdx.z;
  const int hw = a.h * a.w;
  const int row0 = chunk * chunk_rows;
  const int row1 = min(row0 + chunk_rows, hw);
  float sg = 0.f, sgx = 0.f;
  if (ch < a.c) {
    const int nc = n * a.c + ch;
    const float mean = a.mean[nc], inv = a.inv[nc];
    const float scale = kMask ? a.scale[ch] : 0.f;
    const float bias = kMask ? a.bias[ch] : 0.f;
#pragma unroll 4
    for (int r = row0 + ty; r < row1; r += kLanesR) {
      float xhat;
      const float gv = masked_cotangent<kFold, kMask>(a, n, r, ch, mean, inv,
                                                      scale, bias, xhat);
      sg += gv;
      sgx += gv * xhat;
    }
  }
  __shared__ float s_g[kLanesR][kLanesC];
  __shared__ float s_gx[kLanesR][kLanesC];
  s_g[ty][tx] = sg;
  s_gx[ty][tx] = sgx;
  __syncthreads();
  if (ty == 0 && ch < a.c) {
    for (int i = 1; i < kLanesR; ++i) {
      sg += s_g[i][tx];
      sgx += s_gx[i][tx];
    }
    const size_t o = ((size_t)n * chunks + chunk) * a.c + ch;
    part_g[o] = sg;
    part_gx[o] = sgx;
  }
}

// One warp per (n, c): lanes add every 32nd chunk, then each other's sums
// through shuffles.
__global__ void bwd_finalize_kernel(const float* __restrict__ part_g,
                                    const float* __restrict__ part_gx,
                                    int n_total, int c, int chunks,
                                    float* __restrict__ dscale_nc,
                                    float* __restrict__ dbias_nc) {
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= n_total * c) return;  // uniform across the warp
  const int n = idx / c, ch = idx % c;
  float sg = 0.f, sgx = 0.f;
  for (int s = lane; s < chunks; s += 32) {
    const size_t o = ((size_t)n * chunks + s) * c + ch;
    sg += part_g[o];
    sgx += part_gx[o];
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, offset);
    sgx += __shfl_down_sync(0xffffffffu, sgx, offset);
  }
  if (lane == 0) {
    dbias_nc[idx] = sg;
    dscale_nc[idx] = sgx;
  }
}

template <bool kFold, bool kMask>
__global__ void bwd_dx_kernel(Args a, const float* __restrict__ dscale_nc,
                              const float* __restrict__ dbias_nc,
                              float* __restrict__ dx) {
  const int n = blockIdx.y;
  const int hw = a.h * a.w;
  const int total = hw * a.c;
  const float inv_hw = 1.f / (float)hw;
  float* dxn = dx + (size_t)n * total;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ch = i % a.c;
    const int nc = n * a.c + ch;
    const float mean = a.mean[nc], inv = a.inv[nc], scale = a.scale[ch];
    const float bias = kMask ? a.bias[ch] : 0.f;
    float xhat;
    const float gv = masked_cotangent<kFold, kMask>(a, n, i / a.c, ch, mean,
                                                    inv, scale, bias, xhat);
    dxn[i] = scale * inv *
             (gv - dbias_nc[nc] * inv_hw - xhat * (dscale_nc[nc] * inv_hw));
  }
}

template <bool kFold, bool kMask>
cudaError_t launch_backward(const Args& a, int n, int chunk_rows, int chunks,
                            float* part_g, float* part_gx, float* dscale_nc,
                            float* dbias_nc, float* dx, cudaStream_t stream) {
  const dim3 block(kLanesC, kLanesR);
  const dim3 grid(chunks, (a.c + kLanesC - 1) / kLanesC, n);
  bwd_partial_kernel<kFold, kMask><<<grid, block, 0, stream>>>(
      a, chunk_rows, chunks, part_g, part_gx);
  const int finalize_blocks = (int)((32LL * n * a.c + kThreads - 1) / kThreads);
  bwd_finalize_kernel<<<finalize_blocks, kThreads, 0, stream>>>(
      part_g, part_gx, n, a.c, chunks, dscale_nc, dbias_nc);
  const dim3 dx_grid(elementwise_blocks((long long)a.h * a.w * a.c, kThreads),
                     n);
  bwd_dx_kernel<kFold, kMask><<<dx_grid, kThreads, 0, stream>>>(
      a, dscale_nc, dbias_nc, dx);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cg

// K2. x and g [N, HW, C]; part_g and part_gx [N, chunks, C] scratch;
// dscale_nc and dbias_nc the [N, C] partials.
extern "C" int cg_instance_norm_backward(
    const float* x, const float* scale, const float* mean, const float* inv,
    const float* g, float* dx, float* part_g, float* part_gx,
    float* dscale_nc, float* dbias_nc, int n, int hw, int c, int chunk_rows,
    int chunks, void* stream) {
  // x viewed as [N, HW, 1, C] with no pad.
  const cg::Args a{x, g, mean, inv, scale, nullptr, hw, 1, c, 0, 1.f};
  return (int)cg::launch_backward<false, false>(
      a, n, chunk_rows, chunks, part_g, part_gx, dscale_nc, dbias_nc, dx,
      static_cast<cudaStream_t>(stream));
}

// K4. x [N, H, W, C]; g [N, H+2p, W+2p, C]; the rest as K2's.
extern "C" int cg_epilogue_backward(
    const float* x, const float* scale, const float* bias, const float* mean,
    const float* inv, const float* g, float* dx, float* part_g,
    float* part_gx, float* dscale_nc, float* dbias_nc, int n, int h, int w,
    int c, int pad, float slope, int chunk_rows, int chunks, void* stream) {
  const cg::Args a{x, g, mean, inv, scale, bias, h, w, c, pad, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pad > 0) {
    return (int)cg::launch_backward<true, true>(
        a, n, chunk_rows, chunks, part_g, part_gx, dscale_nc, dbias_nc, dx, s);
  }
  return (int)cg::launch_backward<false, true>(
      a, n, chunk_rows, chunks, part_g, part_gx, dscale_nc, dbias_nc, dx, s);
}
