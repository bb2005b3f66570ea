// Launchers and device helpers shared by the kernel sources of the port's
// one shared library.
//
// Every tensor is f32, NHWC-contiguous (channels fastest). Every launcher
// enqueues on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after its launches.
#pragma once

#include <cuda_runtime.h>

namespace cg {

// y = act(((x - mean) * inv) * scale + bias), act(t) = t > 0 ? t :
// slope * t, written as the tf-REFLECT pad(pad) of the result:
// x [N, H, W, C] -> y [N, H+2p, W+2p, C], every element of y once, with
// the statistics given ([N, C]). The tail of the upsample kernels (K5,
// K6), whose statistics come from their GEMM's epilogue (epilogue.cu).
cudaError_t launch_norm_act_pad(const float* x, const float* mean,
                                const float* inv, const float* scale,
                                const float* bias, float* y, int n, int h,
                                int w, int c, int pad, float slope,
                                cudaStream_t stream);

// kVec consecutive channels of one pixel: a 16-byte access when kVec is 4.
template <int kVec>
struct Pack {
  float v[kVec];
};

// A read-only global load through the non-coherent cache.
template <int kVec>
__device__ __forceinline__ Pack<kVec> load(const float* p) {
  Pack<kVec> r;
  if constexpr (kVec == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

// Shared or global memory alike (generic accesses).
template <int kVec>
__device__ __forceinline__ void store(float* p, const Pack<kVec>& r) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    p[0] = r.v[0];
  }
}

template <int kVec>
__device__ __forceinline__ Pack<kVec> load_shared(const float* p) {
  Pack<kVec> r;
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = p[0];
  }
  return r;
}

template <int kVec>
__device__ __forceinline__ void add_to(Pack<kVec>& a, const Pack<kVec>& b) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) a.v[e] += b.v[e];
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async: global -> shared without registers; the thread that copies
// reads the data back after copy_wait.
template <int kVec>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     shared_address(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     shared_address(dst)),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most kPending of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// A thread's place on its band: pixel q of H*W and its row and column.
// step() moves it on by `slots` pixels, back() back by as many, with
// additions only.
struct Cursor {
  int q, row, col;
  __device__ __forceinline__ void step(int slots, int row_step, int col_step,
                                       int w) {
    q += slots;
    col += col_step;
    row += row_step;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
  __device__ __forceinline__ void back(int slots, int row_step, int col_step,
                                       int w) {
    q -= slots;
    col -= col_step;
    row -= row_step;
    if (col < 0) {
      col += w;
      --row;
    }
  }
};

}  // namespace cg
