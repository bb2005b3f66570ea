// Zero-skip upsample forward (f32, NHWC) for Hopper: the 3x3/stride-2
// SAME transposed conv -> instance norm -> ReLU -> tf-REFLECT pad(p), with
// f32 weights (K5) or int8 weights and a per-output-channel scale (K6).
//
// K5 replaces the TPU kernel cyclegan_tpu/ops/pallas/upsample_kernel.py:
// _forward (pallas_call at :142); K6 replaces _forward_int8 (pallas_call
// at :227). The kernel is flax HWIO [3, 3, Cin, Cout] applied without a
// flip. With x[-1] = 0, output pixel (2p+r, 2q+s) is the C_in sum of
// phase (r, s):
//   ee = K00 x[p-1,q-1] + K02 x[p-1,q] + K20 x[p,q-1] + K22 x[p,q]
//   eo = K01 x[p-1,q] + K21 x[p,q]
//   oe = K10 x[p,q-1] + K12 x[p,q]
//   oo = K11 x[p,q]
// so no product ever meets an inserted zero.
//
// Bound: operations (9 * Cin * Cout multiply-adds per input pixel against
// one read of the input and one write of the output). K6's int8 weights
// (0.29 MB and 0.07 MB at the generator's two blocks) change the bytes a
// little and the operations not at all.
//
// Design: the TPU kernel ran each tap as an MXU dot over a whole resident
// slab. Here each phase is an implicit GEMM over (pixels of the H x W
// grid) x (Cout), with depth (taps of the phase) x (Cin): a block computes
// a 64-pixel x 64-channel tile, stepping through the depth 16 at a time
// through shared memory, and each of its 256 threads accumulates a 4 x 4
// sub-tile with f32 FMAs. The missing x[-1] taps load as zeros. The
// phase (blockIdx.z) picks the taps and where the tile lands in the
// interleaved [N, 2H, 2W, Cout] pre-norm output, so the depth-to-space
// interleave costs nothing. The norm tail is then the instance-norm
// kernel's statistics and the epilogue kernel's apply with slope 0 and
// pad p over that output.
//
// K6 is the same kernel templated on the weight type: the B tile loads
// int8 and widens to f32 on its way into shared memory, the FMAs stay
// f32, and each phase's sum is multiplied by kscale[co] once, when the
// tile is stored: the TPU kernel's order (upsample_kernel.py:198), which
// rounds unlike dequantizing the weights first. Integer tensor cores do
// not apply: the activations are f32.
#include <cstdint>
#include <type_traits>

#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kBM = 64;   // pixels per tile
constexpr int kBN = 64;   // output channels per tile
constexpr int kBK = 16;   // depth step
constexpr int kThreads = 256;

// W is float (K5) or int8_t (K6, with kscale [Cout]; nullptr for K5).
template <typename W>
__global__ void __launch_bounds__(kThreads)
phase_conv_kernel(const float* __restrict__ x, const W* __restrict__ k,
                  const float* __restrict__ kscale, float* __restrict__ y,
                  int nb, int h, int w, int cin, int cout) {
  const int phase = blockIdx.z;
  const int pr = phase >> 1, ps = phase & 1;
  // Kernel rows (and their input row offsets) that reach an output row of
  // parity pr: {K0 at p-1, K2 at p} for even rows, {K1 at p} for odd.
  const int n_rows = pr ? 1 : 2;
  const int n_cols = ps ? 1 : 2;
  const int m_total = nb * h * w;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  __shared__ float a_tile[kBK][kBM + 4];
  __shared__ float b_tile[kBK][kBN];

  // The four A rows (pixels) this thread loads, and its depth lane.
  const int a_kk = tid % kBK;
  int a_n[4], a_p[4], a_q[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid + i * kThreads) / kBK;
    a_ok[i] = m < m_total;
    const int mm = a_ok[i] ? m : 0;
    a_n[i] = mm / (h * w);
    const int rem = mm % (h * w);
    a_p[i] = rem / w;
    a_q[i] = rem % w;
  }

  float acc[4][4] = {};
  for (int ti = 0; ti < n_rows; ++ti) {
    const int ka = pr ? 1 : 2 * ti;
    const int dy = (pr || ti) ? 0 : -1;
    for (int tj = 0; tj < n_cols; ++tj) {
      const int kb = ps ? 1 : 2 * tj;
      const int dx = (ps || tj) ? 0 : -1;
      const W* ktap = k + (size_t)(ka * 3 + kb) * cin * cout;
      for (int c0 = 0; c0 < cin; c0 += kBK) {
        const int ci = c0 + a_kk;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sp = a_p[i] + dy, sq = a_q[i] + dx;
          float v = 0.f;
          if (a_ok[i] && ci < cin && sp >= 0 && sq >= 0) {
            v = x[(((size_t)a_n[i] * h + sp) * w + sq) * cin + ci];
          }
          a_tile[a_kk][(tid + i * kThreads) / kBK] = v;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = tid + i * kThreads;
          const int kk = idx / kBN, col = idx % kBN;
          const int kci = c0 + kk, co = n0 + col;
          b_tile[kk][col] = (kci < cin && co < cout)
                                ? static_cast<float>(ktap[(size_t)kci * cout + co])
                                : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = a_tile[kk][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b_tile[kk][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
    const int pn = m / (h * w);
    const int rem = m % (h * w);
    const int oy = 2 * (rem / w) + pr, ox = 2 * (rem % w) + ps;
    float* out = y + (((size_t)pn * 2 * h + oy) * 2 * w + ox) * cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= cout) continue;
      if constexpr (std::is_same<W, int8_t>::value) {
        out[co] = acc[i][j] * kscale[co];
      } else {
        out[co] = acc[i][j];
      }
    }
  }
}

// The phase convolution into conv_out, then the norm tail into y.
template <typename W>
cudaError_t upsample_forward(const float* x, const W* kernel,
                             const float* kscale, const float* scale,
                             const float* bias, float* conv_out, float* y,
                             float* part_mean, float* part_m2, float* mean,
                             float* inv, int n, int h, int w, int cin,
                             int cout, int pad, float eps, int chunk_rows,
                             int chunks, cudaStream_t s) {
  const dim3 grid((n * h * w + kBM - 1) / kBM, (cout + kBN - 1) / kBN, 4);
  phase_conv_kernel<W><<<grid, kThreads, 0, s>>>(x, kernel, kscale, conv_out,
                                                 n, h, w, cin, cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_instance_stats(conv_out, n, 4 * h * w, cout, chunk_rows, chunks,
                              part_mean, part_m2, mean, inv, eps, s);
  if (err != cudaSuccess) return err;
  return launch_norm_act_pad(conv_out, mean, inv, scale, bias, y, n, 2 * h,
                             2 * w, cout, pad, 0.f, s);
}

}  // namespace
}  // namespace cg

// conv_out is the [N, 2H, 2W, Cout] pre-norm scratch; y the
// [N, 2H+2p, 2W+2p, Cout] output.
extern "C" int cg_upsample_forward(const float* x, const float* kernel,
                                   const float* scale, const float* bias,
                                   float* conv_out, float* y,
                                   float* part_mean, float* part_m2,
                                   float* mean, float* inv, int n, int h,
                                   int w, int cin, int cout, int pad,
                                   float eps, int chunk_rows, int chunks,
                                   void* stream) {
  return (int)cg::upsample_forward<float>(
      x, kernel, nullptr, scale, bias, conv_out, y, part_mean, part_m2, mean,
      inv, n, h, w, cin, cout, pad, eps, chunk_rows, chunks,
      static_cast<cudaStream_t>(stream));
}

// K6: kernel_q int8 [3, 3, Cin, Cout], kernel_scale f32 [Cout].
extern "C" int cg_upsample_int8_forward(const float* x, const int8_t* kernel_q,
                                        const float* kernel_scale,
                                        const float* scale, const float* bias,
                                        float* conv_out, float* y,
                                        float* part_mean, float* part_m2,
                                        float* mean, float* inv, int n, int h,
                                        int w, int cin, int cout, int pad,
                                        float eps, int chunk_rows, int chunks,
                                        void* stream) {
  return (int)cg::upsample_forward<int8_t>(
      x, kernel_q, kernel_scale, scale, bias, conv_out, y, part_mean, part_m2,
      mean, inv, n, h, w, cin, cout, pad, eps, chunk_rows, chunks,
      static_cast<cudaStream_t>(stream));
}
