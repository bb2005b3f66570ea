// Conv epilogue forward (f32, NHWC) for Hopper: instance norm ->
// LeakyReLU(slope) -> tf-REFLECT pad(p).
//
// Replaces the TPU kernel cyclegan_tpu/ops/pallas/epilogue_kernel.py:
// _forward (pallas_call at :145). In the generator it runs in every
// residual block with slope 0 and pad 1, writing the padded slab that the
// next VALID conv reads; slope 0.2 with pad 0 is the discriminator's form.
//
// Bound: bytes (x read for the statistics and again for the apply, the
// padded output written once).
//
// Design: the statistics are the instance-norm kernel's chunked Welford
// pass (instance_norm.cu). The apply pass walks the OUTPUT: each thread
// owns output elements (n, r, s, c), so every element of the padded slab
// is written exactly once, with neighbouring threads on neighbouring
// channels; it reads the mirrored source pixel (src = r - p, then -src if
// below 0, then 2(H-1) - src if at or past H; the border is not
// repeated). The TPU kernel built the same slab from static slices and
// concatenations, which a per-element index replaces here.
#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int reflect_index(int i, int size) {
  if (i < 0) i = -i;
  if (i >= size) i = 2 * (size - 1) - i;
  return i;
}

__global__ void norm_act_pad_kernel(const float* __restrict__ x,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ inv,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    float* __restrict__ y, int h, int w,
                                    int c, int pad, float slope) {
  const int n = blockIdx.y;
  const int wp = w + 2 * pad;
  const int total = (h + 2 * pad) * wp * c;
  const float* xn = x + (size_t)n * h * w * c;
  float* yn = y + (size_t)n * total;
#pragma unroll 4
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int ch = i % c;
    int src = i;  // with no pad, each output element reads its own input
    if (pad > 0) {
      const int pix = i / c;
      const int sr = reflect_index(pix / wp - pad, h);
      const int sc = reflect_index(pix % wp - pad, w);
      src = (sr * w + sc) * c + ch;
    }
    const int nc = n * c + ch;
    const float t =
        (xn[src] - mean[nc]) * inv[nc] * scale[ch] + bias[ch];
    // max(t, 0) + slope * min(t, 0) for 0 <= slope <= 1, written so that
    // slope 1 is exactly the identity and a NaN stays a NaN.
    yn[i] = t > 0.f ? t : slope * t;
  }
}

}  // namespace

cudaError_t launch_norm_act_pad(const float* x, const float* mean,
                                const float* inv, const float* scale,
                                const float* bias, float* y, int n, int h,
                                int w, int c, int pad, float slope,
                                cudaStream_t stream) {
  const long long total = (long long)(h + 2 * pad) * (w + 2 * pad) * c;
  const dim3 grid(elementwise_blocks(total, kThreads), n);
  norm_act_pad_kernel<<<grid, kThreads, 0, stream>>>(x, mean, inv, scale,
                                                     bias, y, h, w, c, pad,
                                                     slope);
  return cudaGetLastError();
}

}  // namespace cg

extern "C" int cg_epilogue_forward(const float* x, const float* scale,
                                   const float* bias, float* y,
                                   float* part_mean, float* part_m2,
                                   float* mean, float* inv, int n, int h,
                                   int w, int c, int pad, float slope,
                                   float eps, int chunk_rows, int chunks,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cg::launch_instance_stats(
      x, n, h * w, c, chunk_rows, chunks, part_mean, part_m2, mean, inv, eps,
      s);
  if (err != cudaSuccess) return (int)err;
  return (int)cg::launch_norm_act_pad(x, mean, inv, scale, bias, y, n, h, w,
                                      c, pad, slope, s);
}
