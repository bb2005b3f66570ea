// Launchers and device helpers shared by the kernel sources of the port's
// one shared library.
//
// Every activation is NHWC-contiguous (channels fastest), f32 or bf16
// (T); statistics, norm parameters and every sum are f32. A bf16 element
// is widened to f32 as it is read and rounded to nearest even once, as it
// is written. Every launcher enqueues on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after its launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg {

using bf16 = __nv_bfloat16;

// y = act(((x - mean) * inv) * scale + bias), act(t) = t > 0 ? t :
// slope * t, written as the tf-REFLECT pad(pad) of the result:
// x [N, H, W, C] -> y [N, H+2p, W+2p, C], every element of y once, with
// the statistics given ([N, C]). The tail of the upsample kernels (K5,
// K6), whose statistics come from their GEMM's epilogue (epilogue.cu).
// T is float or bf16; bf16 needs C % 8 == 0 and 16-byte aligned x and y.
template <typename T>
cudaError_t launch_norm_act_pad(const T* x, const float* mean,
                                const float* inv, const float* scale,
                                const float* bias, T* y, int n, int h, int w,
                                int c, int pad, float slope,
                                cudaStream_t stream);

// kVec consecutive channels of one pixel, widened to f32: one 16-byte
// access when kVec * sizeof(T) == 16 (4 floats or 8 bf16), else one f32.
template <int kVec>
struct Pack {
  float v[kVec];
};

// Whether kVec elements of T make one 16-byte access; the only other form
// the kernels take is one f32.
template <int kVec, typename T>
__host__ __device__ constexpr bool wide() {
  static_assert(kVec * sizeof(T) == 16 || (kVec == 1 && sizeof(T) == 4),
                "a pack is 16 bytes, or one float");
  return kVec * sizeof(T) == 16;
}

// 16 bytes of T, widened (a bf16's bits are the high half of its f32).
template <int kVec, typename T>
__device__ __forceinline__ Pack<kVec> widen(const uint4& w) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  Pack<kVec> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      r.v[i] = __uint_as_float(u[i]);
    } else {
      r.v[2 * i] = __uint_as_float(u[i] << 16);
      r.v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  return r;
}

// kVec f32 values as 16 bytes of T, each rounded to nearest even once.
template <int kVec, typename T>
__device__ __forceinline__ uint4 narrow(const Pack<kVec>& r) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      u[i] = __float_as_uint(r.v[i]);
    } else {
      const __nv_bfloat162 p = __floats2bfloat162_rn(r.v[2 * i], r.v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// A read-only global load through the non-coherent cache.
template <int kVec, typename T>
__device__ __forceinline__ Pack<kVec> load(const T* p) {
  if constexpr (wide<kVec, T>()) {
    return widen<kVec, T>(__ldg(reinterpret_cast<const uint4*>(p)));
  } else {
    Pack<kVec> r;
    r.v[0] = __ldg(p);
    return r;
  }
}

// Shared or global memory alike (generic accesses).
template <int kVec, typename T>
__device__ __forceinline__ void store(T* p, const Pack<kVec>& r) {
  if constexpr (wide<kVec, T>()) {
    *reinterpret_cast<uint4*>(p) = narrow<kVec, T>(r);
  } else {
    p[0] = r.v[0];
  }
}

template <int kVec, typename T>
__device__ __forceinline__ Pack<kVec> load_shared(const T* p) {
  if constexpr (wide<kVec, T>()) {
    return widen<kVec, T>(*reinterpret_cast<const uint4*>(p));
  } else {
    Pack<kVec> r;
    r.v[0] = p[0];
    return r;
  }
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
// reads the data back after copy_wait. 16 bytes, or one f32.
template <int kVec, typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  if constexpr (wide<kVec, T>()) {
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
