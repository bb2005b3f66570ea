// Forward instance norm (K1) and conv epilogue (K3), f32 or bf16 NHWC, for
// Hopper: one launch a call that reads x once and keeps it on chip.
//
// Replaces the TPU kernels cyclegan_tpu/ops/pallas/norm_kernel.py:_forward
// (pallas_call at :100) and cyclegan_tpu/ops/pallas/epilogue_kernel.py:
// _forward (pallas_call at :145). Per (n, c): mean and the biased variance
// over H*W, inv = 1/sqrt(var + eps), and
//   t = (x - mean) * inv * scale + bias
//   y = tf-REFLECT pad(p) of (t > 0 ? t : slope * t)
// with mean and inv written out as [N, C]. K1 is the instance with pad 0
// and slope 1 (the identity; a NaN stays a NaN), over x viewed as
// [N, HW, 1, C]; K3 runs in every residual block with slope 0 and pad 1,
// and in the discriminator with slope 0.2 and pad 0.
//
// Bound: bytes. x is read once and y written once, with a few operations
// an element, far below the card's operations-per-byte balance. At the
// most-launched shape ([1, 64, 64, 256]) that is 8.4 MB in f32, 2.5 us at
// 3.35 TB/s (half in bf16), so a launch's fixed costs weigh as much as the
// bytes.
//
// Element type T: f32, or bf16 (the JAX package's bfloat16 compute, where
// the kernel reads bf16, keeps its statistics in f32 and writes bf16,
// norm_kernel.py:78-89). A bf16 element is widened to f32 in registers as
// it leaves shared memory, where the band stays in bf16, so a block holds
// twice the pixels; every sum, the merge and the apply are the f32 ones,
// and y is rounded to nearest even once, at its store.
//
// Plan (ops/cuda/norm_kernel.py forward_plan, computed in Python from the
// shapes and the SM count, passed in and checked here): each (sample,
// channel tile) is a group of `group` blocks, and block `rank` of a group
// owns the pixels [rank * band, (rank + 1) * band) of H*W. A tile of 64
// channels keeps a warp's 16-byte copies on whole 128-byte lines at every
// full-width shape, C = 64 included, where a tile is a whole pixel. The
// grid is (group, slabs) and holds at most one block an SM, so it is on
// the card at once; a launch the card cannot hold so is refused (a
// cooperative launch), never run. Where the N * tiles groups' slabs do not
// all fit in the card's shared memory at once (batch 4 at 256^2), the grid
// takes `slabs` groups at a time, in `waves` turns, each group's slab on
// chip in its turn: group wave * slabs + blockIdx.y is (sample, tile) =
// divmod(that, tiles). A block's 256 threads are tile / kVec lanes of kVec
// channels (16-byte accesses along C, 4 floats or 8 bf16, when C is a
// multiple of kVec and x and y are 16-byte aligned; else, in f32 only,
// 4-byte ones) times 256 / lanes pixel slots.
//
// One launch, in four steps a group:
//   1. Copy the band into shared memory with cp.async, every copy of a
//      thread in flight at once in groups of kChunk elements, and add up
//      each group as it lands.
//   2. The block's (mean, M2) per channel, two passes over the band on
//      chip: the sums (shuffles, then one row a warp in shared memory),
//      then the squares about the block's mean. No E[x^2] - E[x]^2, which
//      would cancel on conv outputs with a large mean.
//   3. Exchange through device memory. Each block writes its partial to
//      its place in the group's table, fences, and adds one to the group's
//      counter; it waits until the counter reaches the group's size (an
//      acquire load), copies the whole table into shared memory at once
//      (cp.async, one round trip to L2 however large the group), and
//      merges the partials in a fixed order, in double, by Chan's parallel
//      formula in its k-way form (mean = sum of count_r * mean_r over H*W,
//      M2 = sum of M2_r + count_r * (mean_r - mean)^2, taken in one pass
//      about the first rank's mean), then inv = rsqrt(M2 / HW + eps), each
//      rounded to f32 once. Every block reads the same table in the same
//      order, so every block holds the same mean and inv bit for bit. The
//      counter counts on to twice the group's size as the blocks leave,
//      and the last block to leave sets it back to 0, so the per-stream
//      counters are zero at every launch without a memset. (Thread-block
//      clusters exchanging over distributed shared memory, where a group
//      fits one, were slower on the card: PERF.md, Findings, PR 9.)
//   4. Apply from shared memory and write y: each source element is
//      normalised once and stored at its own padded place and, on the
//      border, at each place the reflect pad copies it to (up to 3 x 3),
//      so every element of y is written once, from data on chip, with
//      16-byte stores along C.
// No float atomics: two calls on the same inputs give bitwise-equal y,
// mean and inv. A group that has not filled within a second traps (a
// launch error) instead of hanging the card.
#include <mutex>

#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;  // channels of a group, at most
constexpr int kChunk = 4;     // elements of a thread in one copy group
constexpr int kMaxPending = 7;
constexpr int kMergeChains = 4;  // independent sums a merging lane keeps

template <typename T>
struct Args {
  const T* x;          // [N, H, W, C]
  const float* scale;  // [C]
  const float* bias;   // [C]
  T* y;                // [N, H+2p, W+2p, C]
  float* mean;         // [N, C]
  float* inv;          // [N, C]
  float2* part;        // [N * tiles, tile, group]: each block's (mean, M2)
  unsigned* counters;  // [N * tiles], zero between launches
  int n, h, w, c, pad;
  float slope, eps;
  double inv_hw;  // 1 / (H * W)
  int tile;   // channels of a group
  int group;  // blocks of a group (gridDim.x)
  int band;   // pixels of H*W a block
  int slabs;  // groups a wave (gridDim.y)
  int waves;
};

// Wait until at most `pending` of this thread's copy groups are in flight
// (at most kMaxPending: waiting for more than needed is still right).
__device__ __forceinline__ void copy_wait_at_most(int pending) {
  switch (pending < kMaxPending ? pending : kMaxPending) {
    case 0: copy_wait<0>(); break;
    case 1: copy_wait<1>(); break;
    case 2: copy_wait<2>(); break;
    case 3: copy_wait<3>(); break;
    case 4: copy_wait<4>(); break;
    case 5: copy_wait<5>(); break;
    case 6: copy_wait<6>(); break;
    default: copy_wait<kMaxPending>(); break;
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block's per-channel total of each thread's kVec sums: threads of one
// lane within a warp by shuffles, then the warps' rows in order, into
// s_out[0 .. tile).
template <int kVec>
__device__ __forceinline__ void block_sum(Pack<kVec> v, int tile, int lanes,
                                          int lane, int slot,
                                          float (*s_red)[kMaxTile],
                                          float* s_out) {
  for (int offset = lanes; offset < 32; offset <<= 1) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v.v[j] += __shfl_xor_sync(0xffffffffu, v.v[j], offset);
    }
  }
  const int per_warp = lanes < 32 ? 32 / lanes : 1;  // slots a warp holds
  const int rows = (kThreads / lanes) / per_warp;    // at most kWarps
  if (slot % per_warp == 0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) s_red[slot / per_warp][lane * kVec + j] = v.v[j];
  }
  __syncthreads();
  if ((int)threadIdx.x < tile) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) {
      if (r < rows) total += s_red[r][threadIdx.x];
    }
    s_out[threadIdx.x] = total;
  }
  __syncthreads();
}

__device__ __forceinline__ double2 operator+(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

// A merging lane's sum of f(r) over the ranks r = first, first + step, ...
// below `count`, in kMergeChains interleaved chains added in a fixed order.
template <typename F>
__device__ __forceinline__ double2 strided_sum(int first, int step, int count,
                                               F f) {
  double2 chain[kMergeChains];
#pragma unroll
  for (int k = 0; k < kMergeChains; ++k) chain[k] = make_double2(0.0, 0.0);
  int r = first;
  for (; r + (kMergeChains - 1) * step < count; r += kMergeChains * step) {
#pragma unroll
    for (int k = 0; k < kMergeChains; ++k) chain[k] = chain[k] + f(r + k * step);
  }
  for (; r < count; r += step) chain[0] = chain[0] + f(r);
  return (chain[0] + chain[1]) + (chain[2] + chain[3]);
}

// Sum over the `width` consecutive lanes of a warp that share a channel (a
// power of two), in a fixed tree; every lane gets the total.
__device__ __forceinline__ double2 lanes_total(double2 v, int width) {
  for (int offset = width / 2; offset > 0; offset >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, offset);
    v.y += __shfl_down_sync(0xffffffffu, v.y, offset);
  }
  const int leader = (threadIdx.x & 31) & ~(width - 1);
  return make_double2(__shfl_sync(0xffffffffu, v.x, leader),
                      __shfl_sync(0xffffffffu, v.y, leader));
}

template <typename T, int kVec, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
norm_forward_kernel(Args<T> a) {
  // The band (element e of thread t at (e * kThreads + t) * kVec floats),
  // then the group's table of partials.
  extern __shared__ float4 s_dynamic[];
  __shared__ float s_red[kWarps][kMaxTile];
  __shared__ float s_mean[kMaxTile];  // the block's mean, then the group's
  __shared__ float s_inv[kMaxTile];

  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int tiles = (a.c + a.tile - 1) / a.tile;
  const int lanes = a.tile / kVec;  // a power of two
  const int slots = kThreads / lanes;
  const int lane = tid % lanes, slot = tid / lanes;
  const int hw = a.h * a.w;
  const int q0 = min(rank * a.band, hw);
  const int count = min(q0 + a.band, hw) - q0;
  // This thread's pixels q0 + slot + e * slots, e < elems, in copy groups
  // of kChunk.
  const int elems = count > slot ? (count - 1 - slot) / slots + 1 : 0;
  const int chunks = (elems + kChunk - 1) / kChunk;
  constexpr int kStride = kThreads * kVec;
  T* mine = reinterpret_cast<T*>(s_dynamic) + tid * kVec;
  float2* s_table = reinterpret_cast<float2*>(
      reinterpret_cast<T*>(s_dynamic) +
      (size_t)((a.band + slots - 1) / slots) * kStride);
  // The pixel's row and column, for the pad: the only divisions by W.
  const Cursor start{q0 + slot, (q0 + slot) / a.w, (q0 + slot) % a.w};
  const int row_step = slots / a.w, col_step = slots % a.w;
  // The merge: `width` threads a channel of the tile (a power of two).
  const int width = min(32, kThreads / a.tile);
  const int m_ch = tid / width, m_lane = tid % width;
  const bool merging = m_ch < a.tile;
  const float inv_count = count > 0 ? 1.f / count : 0.f;

  for (int wave = 0; wave < a.waves; ++wave) {
    const int gi = wave * a.slabs + blockIdx.y;
    if (gi >= a.n * tiles) break;  // uniform across the block
    const int n = gi / tiles, tile_i = gi - n * tiles;
    const int ch = tile_i * a.tile + lane * kVec;
    // With kVec 4, C % 4 == 0: a lane's channels are all valid or none.
    const bool active = ch < a.c;
    // The previous group's band is read out before it is refilled.
    __syncthreads();
    const T* xn = a.x + (size_t)n * hw * a.c + ch;

    // 1. Copy the band, and add up each copy group as it lands.
    for (int g = 0; g < chunks; ++g) {
      if (active) {
        for (int e = g * kChunk; e < min(elems, (g + 1) * kChunk); ++e) {
          copy_async<kVec>(mine + (size_t)e * kStride,
                           xn + (size_t)(q0 + slot + e * slots) * a.c);
        }
      }
      copy_commit();
    }
    Pack<kVec> scale, bias;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      scale.v[j] = active ? a.scale[ch + j] : 0.f;
      bias.v[j] = active ? a.bias[ch + j] : 0.f;
    }
    Pack<kVec> sum;
#pragma unroll
    for (int j = 0; j < kVec; ++j) sum.v[j] = 0.f;
    for (int g = 0; g < chunks; ++g) {
      copy_wait_at_most(chunks - 1 - g);
#pragma unroll
      for (int e = g * kChunk; e < min(elems, (g + 1) * kChunk); ++e) {
        add_to(sum, load_shared<kVec>(mine + (size_t)e * kStride));
      }
    }

    // 2. The block's mean (its sum times 1 / count), then its M2 about it.
    block_sum<kVec>(sum, a.tile, lanes, lane, slot, s_red, s_mean);
    Pack<kVec> block_mean, sq;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      block_mean.v[j] = s_mean[lane * kVec + j] * inv_count;
      sq.v[j] = 0.f;
    }
#pragma unroll 4
    for (int e = 0; e < elems; ++e) {
      const Pack<kVec> v = load_shared<kVec>(mine + (size_t)e * kStride);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v.v[j] - block_mean.v[j];
        sq.v[j] += d * d;
      }
    }
    // s_inv holds the block's M2 until the merge.
    block_sum<kVec>(sq, a.tile, lanes, lane, slot, s_red, s_inv);

    // 3. Exchange the partials through device memory and merge them: the
    // table's row of this block, a fence, one arrival on the group's
    // counter, a wait until every block of the group has arrived, then the
    // whole table at once into shared memory (cp.async, one round trip to
    // L2 however large the group; a whole number of 16-byte copies, the
    // tile being even). The table is channel-major, [tile][group], so that
    // the lanes merging one channel read neighbouring words.
    unsigned* counter = a.counters + gi;
    float2* table = a.part + (size_t)gi * a.group * a.tile;
    if (tid < a.tile) {
      table[tid * a.group + rank] =
          make_float2(s_mean[tid] * inv_count, s_inv[tid]);
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) {
      atomicAdd(counter, 1u);
      const unsigned long long t0 = global_ns();
      while (load_acquire(counter) < (unsigned)a.group) {
        __nanosleep(32);
        if (global_ns() - t0 > 1000000000ull) __trap();
      }
    }
    __syncthreads();
    for (int i = tid; i < a.group * a.tile / 2; i += kThreads) {
      copy_async<4>(reinterpret_cast<float*>(s_table) + 4 * i,
                    reinterpret_cast<const float*>(table) + 4 * i);
    }
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    // Every rank holds `band` pixels but the last, which holds the rest.
    // One pass about the first rank's mean k: s1 = sum n_r (m_r - k) and
    // s2 = sum M2_r + n_r (m_r - k)^2, whence mean = k + s1 / HW and
    // M2 = s2 - s1^2 / HW; in double, k within the data's spread loses
    // nothing that the f32 results keep.
    const float2* rows = s_table + (merging ? m_ch : 0) * a.group;
    const int last = a.group - 1;
    const double k = rows[0].x, last_count = hw - last * a.band;
    const int first = merging ? m_lane : last;  // idle lanes sum nothing
    double2 s12 = strided_sum(first, width, last, [&](int r) {
      const double d = rows[r].x - k;
      return make_double2(a.band * d, rows[r].y + a.band * d * d);
    });
    s12 = lanes_total(s12, width);
    const double d_last = rows[last].x - k;
    const double s1 = s12.x + last_count * d_last;
    const double s2 = s12.y + rows[last].y + last_count * d_last * d_last;
    const double mean = k + s1 * a.inv_hw;
    const double m2 = s2 - s1 * s1 * a.inv_hw;
    if (merging && m_lane == 0) {
      s_mean[m_ch] = (float)mean;
      s_inv[m_ch] = (float)rsqrt(m2 * a.inv_hw + (double)a.eps);
    }
    __syncthreads();
    if (rank == 0 && tid < a.tile && tile_i * a.tile + tid < a.c) {
      a.mean[(size_t)n * a.c + tile_i * a.tile + tid] = s_mean[tid];
      a.inv[(size_t)n * a.c + tile_i * a.tile + tid] = s_inv[tid];
    }
    if (!active) continue;

    // 4. Apply from shared memory and write every place of y the element
    // goes to.
    Pack<kVec> mu, iv;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mu.v[j] = s_mean[lane * kVec + j];
      iv.v[j] = s_inv[lane * kVec + j];
    }
    const int wp = a.w + 2 * a.pad;
    T* yn = a.y + (size_t)n * (a.h + 2 * a.pad) * wp * a.c + ch;
    Cursor at = start;
#pragma unroll 4
    for (int e = 0; e < elems; ++e) {
      Pack<kVec> v = load_shared<kVec>(mine + (size_t)e * kStride);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float t = (v.v[j] - mu.v[j]) * iv.v[j] * scale.v[j] + bias.v[j];
        v.v[j] = t > 0.f ? t : a.slope * t;
      }
      if constexpr (kPad) {
        const int p = a.pad, col = at.col, row = at.row;
        auto put_row = [&](int out_row) {
          T* r = yn + (size_t)out_row * wp * a.c;
          store<kVec>(r + (size_t)(col + p) * a.c, v);
          if (col >= 1 && col <= p) store<kVec>(r + (size_t)(p - col) * a.c, v);
          if (col >= a.w - 1 - p && col <= a.w - 2) {
            store<kVec>(r + (size_t)(2 * a.w - 2 - col + p) * a.c, v);
          }
        };
        put_row(row + p);
        if (row >= 1 && row <= p) put_row(p - row);
        if (row >= a.h - 1 - p && row <= a.h - 2) put_row(2 * a.h - 2 - row + p);
        at.step(slots, row_step, col_step, a.w);
      } else {
        store<kVec>(yn + (size_t)(q0 + slot + e * slots) * a.c, v);
      }
    }
    // Leave, once this thread's stores are issued: the last block of the
    // group to leave sets its counter back to 0. (Thread 0 is always
    // active: lane 0 of a tile holds a channel.)
    if (tid == 0 && atomicAdd(counter, 1u) == 2u * a.group - 1u) {
      atomicExch(counter, 0u);
    }
  }
}

template <typename T>
using Kernel = void (*)(Args<T>);

template <typename T>
Kernel<T> pick_kernel(int vec, bool pad) {
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) {
      return pad ? norm_forward_kernel<T, 8, true>
                 : norm_forward_kernel<T, 8, false>;
    }
  } else {
    if (vec == 4) {
      return pad ? norm_forward_kernel<T, 4, true>
                 : norm_forward_kernel<T, 4, false>;
    }
    if (vec == 1) {
      return pad ? norm_forward_kernel<T, 1, true>
                 : norm_forward_kernel<T, 1, false>;
    }
  }
  return nullptr;
}

// Let `kernel` take as much dynamic shared memory as a block may opt in
// to, once per kernel.
cudaError_t prepare(const void* kernel) {
  static std::mutex lock;
  static const void* prepared[8];
  static int n_prepared = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_prepared; ++i) {
    if (prepared[i] == kernel) return cudaSuccess;
  }
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  }
  if (e == cudaSuccess && n_prepared < 8) prepared[n_prepared++] = kernel;
  return e;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch_forward(const Args<T>& a, int vec, int smem,
                           cudaStream_t stream) {
  const Kernel<T> kernel = pick_kernel<T>(vec, a.pad > 0);
  const long long hw = (long long)a.h * a.w;
  const int tiles = a.tile > 0 ? (a.c + a.tile - 1) / a.tile : 0;
  const int lanes = vec > 0 ? a.tile / vec : 0;
  const long long per_thread =
      lanes > 0 ? (a.band + kThreads / lanes - 1) / (kThreads / lanes) : 0;
  const bool wide = vec * (int)sizeof(T) == 16;
  if (kernel == nullptr || a.c % vec != 0 ||
      (wide && !(aligned16(a.x) && aligned16(a.y))) || a.tile < vec ||
      a.tile > kMaxTile || (a.tile & (a.tile - 1)) != 0 || a.group < 1 ||
      a.band < 1 || (long long)a.group * a.band < hw ||
      (long long)(a.group - 1) * a.band >= hw || a.slabs < 1 ||
      a.slabs > 65535 || a.waves < 1 ||
      (long long)a.slabs * a.waves < (long long)a.n * tiles ||
      (long long)a.slabs * (a.waves - 1) >= (long long)a.n * tiles ||
      a.pad < 0 || (a.pad > 0 && (a.pad >= a.h || a.pad >= a.w)) ||
      a.tile < 2 ||
      (long long)sizeof(T) * per_thread * kThreads * vec +
              8LL * a.group * a.tile >
          smem) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = prepare(reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.group, a.slabs, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  // A cooperative launch: the runtime refuses a grid that the card cannot
  // hold at once, whose groups would wait on blocks that never start.
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeCooperative;
  attribute.val.cooperative = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The launch of either element type: esize 4 (f32) or 2 (bf16).
cudaError_t launch_typed(const void* x, const float* scale, const float* bias,
                         void* y, float* mean, float* inv, void* part,
                         unsigned* counters, int n, int h, int w, int c,
                         int pad, float slope, float eps, int vec, int tile,
                         int group, int band, int slabs, int waves, int smem,
                         int esize, void* stream) {
  const double inv_hw = 1.0 / ((double)h * w);
  const auto s = static_cast<cudaStream_t>(stream);
  if (esize == 4) {
    const Args<float> a{static_cast<const float*>(x), scale, bias,
                        static_cast<float*>(y), mean, inv,
                        static_cast<float2*>(part), counters, n, h, w, c, pad,
                        slope, eps, inv_hw, tile, group, band, slabs, waves};
    return launch_forward(a, vec, smem, s);
  }
  if (esize == 2) {
    const Args<bf16> a{static_cast<const bf16*>(x), scale, bias,
                       static_cast<bf16*>(y), mean, inv,
                       static_cast<float2*>(part), counters, n, h, w, c, pad,
                       slope, eps, inv_hw, tile, group, band, slabs, waves};
    return launch_forward(a, vec, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cg

// The plan's fields, as forward_plan returns them: vec (4 or 1 for f32, 8
// for bf16), tile, group (blocks a group), band (pixels of H*W a block),
// slabs (groups a wave), waves, smem (bytes of dynamic shared memory a
// block: the band and the group's table) and esize (bytes an element of x
// and y: 4 f32, 2 bf16). part holds N * tiles * group * tile float2 and
// counters N * tiles zeros.

// K1: x [N, HW, C], y as x.
extern "C" int cg_instance_norm_forward(
    const void* x, const float* scale, const float* bias, void* y,
    float* mean, float* inv, void* part, unsigned* counters, int n, int hw,
    int c, float eps, int vec, int tile, int group, int band, int slabs,
    int waves, int smem, int esize, void* stream) {
  // x viewed as [N, HW, 1, C] with no pad and slope 1.
  return (int)cg::launch_typed(x, scale, bias, y, mean, inv, part, counters,
                               n, hw, 1, c, 0, 1.f, eps, vec, tile, group,
                               band, slabs, waves, smem, esize, stream);
}

// K3: x [N, H, W, C], y [N, H+2p, W+2p, C].
extern "C" int cg_epilogue_forward(
    const void* x, const float* scale, const float* bias, void* y,
    float* mean, float* inv, void* part, unsigned* counters, int n, int h,
    int w, int c, int pad, float slope, float eps, int vec, int tile,
    int group, int band, int slabs, int waves, int smem, int esize,
    void* stream) {
  return (int)cg::launch_typed(x, scale, bias, y, mean, inv, part, counters,
                               n, h, w, c, pad, slope, eps, vec, tile, group,
                               band, slabs, waves, smem, esize, stream);
}

extern "C" const char* cg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
