#!/usr/bin/env python3
"""The rate of TF32 ``mma.sync.m16n8k8`` on the card, the route the port's
upsample kernels (K5, K6; ``cyclegan_tpu_torch/csrc/upsample.cu``) take to
the tensor cores.

  python3 tools/mma_sync_rate.py

Builds a small CUDA program with the port's nvcc flags into the
git-ignored ``cyclegan_tpu_torch/_build/`` and runs it: every SM runs
``warps`` warps, each issuing ``chains`` independent chains of dependent
MMAs on fixed operands. Prints the card's name and power limit, then one
JSON line per (warps, chains) with the TFLOP/s reached and the ns an SM
sub-partition spends per MMA. With few chains this is the latency of a
dependent MMA; with enough, the throughput, which bounds any kernel that
issues m16n8k8 TF32 MMAs below the 495 TFLOP/s the data sheet gives for
dense TF32.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cyclegan_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kChains>
__global__ void chains(float* out, int iters) {
  // Normal floats, as TF32 operands.
  const float f = 1.0f + threadIdx.x * 0.01f;
  const uint32_t a[4] = {__float_as_uint(f), __float_as_uint(-f),
                         __float_as_uint(0.5f * f), __float_as_uint(2.0f)},
                 b[2] = {__float_as_uint(0.25f), __float_as_uint(-1.5f)};
  float d[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma(d[c], a, b);
  }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 1024 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  for (int warps : {4, 8, 16}) {
    for (int c : {1, 2, 4, 8}) {
      auto k = c == 1 ? chains<1> : c == 2 ? chains<2> : c == 4 ? chains<4>
                                                                 : chains<8>;
      k<<<sms, 32 * warps>>>(out, 16);
      cudaEventRecord(e0);
      k<<<sms, 32 * warps>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mmas = (double)sms * warps * c * iters;
      printf("{\"warps_per_sm\": %d, \"chains_per_warp\": %d, \"ms\": %.4f, "
             "\"tflops\": %.1f, \"ns_per_mma_per_subpartition\": %.3f}\n",
             warps, c, ms, mmas * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12,
             ms * 1e6 / (mmas / sms / 4));
    }
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "mma_sync_rate.cu")
    exe = os.path.join(build.BUILD_DIR, "mma_sync_rate")
    with open(src, "w") as f:
        f.write(SOURCE)
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([build.nvcc_path(), *flags, "-o", exe, src], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
