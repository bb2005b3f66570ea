// Launchers shared by the kernel sources of the port's one shared library.
//
// Every tensor is f32, NHWC-contiguous (channels fastest). Every launcher
// enqueues on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after its launches.
#pragma once

#include <cuda_runtime.h>

namespace cg {

// Blocks for a grid-stride elementwise pass over `total` elements of one
// sample: enough to fill the card, few enough to amortise the indexing.
inline int elementwise_blocks(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return blocks < 1024 ? (int)blocks : 1024;
}

// Per-(n, c) statistics of x [N, HW, C] over HW: mean and
// inv = 1/sqrt(var + eps), var the biased variance. Pass 1 gathers a
// (mean, M2) partial per chunk of `chunk_rows` rows into part_mean and
// part_m2 ([N, chunks, C] scratch); pass 2 combines the partials of each
// (n, c) with Chan's parallel formula and writes mean and inv ([N, C]).
cudaError_t launch_instance_stats(const float* x, int n, int hw, int c,
                                  int chunk_rows, int chunks,
                                  float* part_mean, float* part_m2,
                                  float* mean, float* inv, float eps,
                                  cudaStream_t stream);

// y = act(((x - mean) * inv) * scale + bias), act(t) = max(t, 0) +
// slope * min(t, 0), written as the tf-REFLECT pad(pad) of the result:
// x [N, H, W, C] -> y [N, H+2p, W+2p, C], every element of y once. With
// pad 0 and slope 1 it is the plain instance-norm apply.
cudaError_t launch_norm_act_pad(const float* x, const float* mean,
                                const float* inv, const float* scale,
                                const float* bias, float* y, int n, int h,
                                int w, int c, int pad, float slope,
                                cudaStream_t stream);

}  // namespace cg
