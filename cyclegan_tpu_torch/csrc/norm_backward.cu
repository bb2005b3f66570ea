// Backward of instance norm (K2) and of the conv epilogue (K4), f32 or bf16
// NHWC, for Hopper: one launch per call, a thread-block cluster per
// (sample, channel tile).
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
// K2 is the same with no fold and no mask, over x viewed as [N, HW, 1, C].
//
// Bound: bytes. x and g are read and dx is written, each once at best,
// with about 15 operations per element, far below the card's
// operations-per-byte balance. At the train step's most-launched shape
// ([1, 64, 64, 256]) the three tensors are 12.6 MB, 3.8 us at 3.35 TB/s, so
// a launch's fixed costs (the launch, the exchange between blocks, a second
// pass over memory) weigh as much as the bytes.
//
// Element type T of x, g and dx: f32, or bf16 (the JAX package's bfloat16
// compute: the kernel reads bf16 and computes in f32, norm_kernel.py:
// 136-139). bf16 elements are widened to f32 as they are read and dx is
// rounded to nearest even once, at its store; the sums and the dscale and
// dbias partials stay f32. In bf16 the band stays on chip as the raw x and
// g (4 bytes an element, where f32 keeps g2 and xhat, 8), and the second
// pass forms xhat and g2 again from them: the fold's mirrors are read again
// (from L2, the border only) and the mask is recomputed from x, mean and
// inv, never from a stored output.
//
// Plan (ops/cuda/norm_kernel.py backward_plan, computed in Python from the
// shapes and the SM count and passed in): a channel tile of `tile`
// channels (a power of two, at most 64) and a cluster of `cluster` blocks
// (at most 16) for each (n, tile); the grid is (cluster, tiles, N), and
// block `rank` owns the pixels [rank * band, (rank + 1) * band) of H*W. A
// cluster waits for its slowest block, so the plan keeps the whole grid on
// the card at once (three blocks an SM, two in bf16: kMinBlocks caps the
// registers, the plan a block's shared memory). A block's 256 threads are
// tile / kVec lanes of kVec channels (16-byte accesses along C, 4 floats
// or 8 bf16, when C is a multiple of kVec and the pointers are 16-byte
// aligned; else, in f32 only, 4-byte ones) times 256 / lanes pixel slots; a thread walks its pixels with a stride of the slot count,
// tracking row and column by additions, so no element divides by W or C.
//
// One launch, in four steps:
//   1. Read x and g once (cp.async, so a thread's copies are all in flight
//      without holding registers), fold and mask g into g2, form xhat, and
//      add g2 and g2 * xhat to the thread's sums. Where the plan's band fits
//      ("keep 2"), the copies land in the band's place in shared memory and
//      g2 and xhat replace them there. Where it does not, a ring of kRing
//      elements a thread stages the copies, and g2 alone stays ("keep 1":
//      [1, 128, 128, 128], g2 and xhat of a band would take more than a
//      third of an SM) or nothing does ("keep 0": [1, 256, 256, 64], where
//      even g2 is 16.8 MB).
//   2. Shuffles, then one row a warp in shared memory, reduce the threads'
//      sums to the block's.
//   3. Each block sends its sums to its row of every block's table with
//      st.async, which completes bytes on the receiver's mbarrier; each
//      block waits on its own mbarrier alone and adds the rows in rank
//      order, so every block holds the same (n, c) sums. Block 0 writes
//      dscale and dbias. A cluster barrier arrived at on entry and waited
//      on just before the first send makes sure every mbarrier exists.
//   4. Write dx of the same elements: from shared memory with keep 2;
//      otherwise this second pass inside the launch, which the largest
//      shapes need, reads x (keep 1) or x and g (keep 0) again through the
//      ring, back to front, so that what step 1 read last, the likeliest
//      still in L2, comes first.
// There is no scratch tensor, no second kernel and no atomic: every sum is
// taken in a fixed order, so two calls on the same inputs give bitwise
// equal outputs. A cluster that cannot be scheduled fails the launch.
//
// The fold gathers rather than scatters. Interior element (i, j) takes
// padded (i + p, j + p) and, only at the border, the mirrors of its row
// (p - i for 1 <= i <= p; p + 2H - 2 - i for H - 1 - p <= i <= H - 2) and
// of its column, under predicates: at most 3 x 3 loads, one for an
// interior element, with no indexed array. Rows are folded before columns,
// the order of the plain version. The activation mask is recomputed from x
// and the saved statistics with pre rounded op by op, as the plain version
// and the JAX kernel (jnp.where(pre > 0, g, slope * g)) compute it, so the
// forward saves nothing more than the plain instance norm does.
#include <mutex>

#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;     // channels of one cluster, at most
constexpr int kMaxCluster = 16;  // blocks of one cluster, at most
constexpr int kRing = 2;         // elements a thread stages ahead off chip
// Blocks an SM holds, at least: the cap on a thread's registers. A bf16
// thread holds 8 channels' values where an f32 one holds 4, so it gets the
// registers of 2 blocks an SM.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 3;

template <typename T>
struct Args {
  const T* x;          // [N, H, W, C]
  const T* g;          // [N, H+2p, W+2p, C]
  const float* mean;   // [N, C]
  const float* inv;    // [N, C]
  const float* scale;  // [C]
  const float* bias;   // [C], read only with the mask
  T* dx;               // [N, H, W, C]
  float* dscale_nc;    // [N, C]
  float* dbias_nc;     // [N, C]
  int h, w, c, pad;
  float slope;
  int tile;            // channels of one cluster
  int band;            // pixels of H*W in one block's band
  int keep;            // what of the band stays in shared memory between
                       // the passes: 2 g2 and xhat (bf16: g and x), 1 g2
                       // (bf16: g), 0 nothing
};

// Where an interior index i of a dimension of `size` takes mirrored
// cotangent from under a reflect pad p, as offsets in padded positions
// from its own source i + p: `lo` from p - i (1 <= i <= p), `hi` from
// p + 2 * size - 2 - i (size - 1 - p <= i <= size - 2).
struct Mirrors {
  bool lo, hi;
  int lo_off, hi_off;
};

__device__ __forceinline__ Mirrors mirrors(int i, int size, int pad) {
  Mirrors m;
  m.lo = i >= 1 && i <= pad;
  m.hi = i >= size - 1 - pad && i <= size - 2;
  m.lo_off = -2 * i;
  m.hi_off = 2 * size - 2 - 2 * i;
  return m;
}

// The element's own source in g: padded (row + p, col + p) under a fold,
// else the same pixel.
template <bool kFold, typename T>
__device__ __forceinline__ const T* g_source(const Args<T>& a, const T* gn,
                                             const Cursor& c) {
  if constexpr (kFold) {
    return gn +
           ((size_t)(c.row + a.pad) * (a.w + 2 * a.pad) + c.col + a.pad) * a.c;
  } else {
    return gn + (size_t)c.q * a.c;
  }
}

// The folded cotangent from `own`, the value at the element's own source
// p: only a border row or column adds its mirrors (at most 3 x 3 loads),
// under predicates. Rows are folded before columns, the order of the
// plain version.
template <bool kFold, int kVec, typename T>
__device__ __forceinline__ Pack<kVec> fold(const Args<T>& a, Pack<kVec> own,
                                           const T* p, const Cursor& c) {
  if constexpr (kFold) {
    const int col_stride = a.c, row_stride = (a.w + 2 * a.pad) * a.c;
    const Mirrors r = mirrors(c.row, a.h, a.pad);
    const Mirrors m = mirrors(c.col, a.w, a.pad);
    auto column = [&](const T* q, Pack<kVec> v) {
      if (r.lo) add_to(v, load<kVec>(q + r.lo_off * row_stride));
      if (r.hi) add_to(v, load<kVec>(q + r.hi_off * row_stride));
      return v;
    };
    own = column(p, own);
    if (m.lo) {
      const T* q = p + m.lo_off * col_stride;
      add_to(own, column(q, load<kVec>(q)));
    }
    if (m.hi) {
      const T* q = p + m.hi_off * col_stride;
      add_to(own, column(q, load<kVec>(q)));
    }
  }
  return own;
}

// The per-channel values a thread needs for its kVec channels.
template <int kVec>
struct Channels {
  Pack<kVec> mean, inv, scale, bias;
};

// xhat of x, rounded op by op as the plain version computes it, so that
// the mask below picks the same side of 0 (no fused multiply-add here).
template <int kVec>
__device__ __forceinline__ Pack<kVec> xhat_of(const Pack<kVec>& xv,
                                              const Channels<kVec>& k) {
  Pack<kVec> xhat;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    xhat.v[e] = __fmul_rn(__fsub_rn(xv.v[e], k.mean.v[e]), k.inv.v[e]);
  }
  return xhat;
}

// The activation's mask on g, in place: jnp.where(pre > 0, g, slope * g),
// pre == 0 taking the slope branch.
template <bool kMask, int kVec>
__device__ __forceinline__ void mask(Pack<kVec>& g, const Pack<kVec>& xhat,
                                     const Channels<kVec>& k, float slope) {
  if constexpr (kMask) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float pre = __fadd_rn(__fmul_rn(xhat.v[e], k.scale.v[e]),
                                  k.bias.v[e]);
      g.v[e] = pre > 0.f ? g.v[e] : slope * g.v[e];
    }
  }
}

// The block of `rank` in this block's cluster: the shared-memory address
// there of this block's `addr` (mapa).
__device__ __forceinline__ unsigned remote_address(const void* addr,
                                                   int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(shared_address(addr)), "r"(rank));
  return out;
}

template <typename T, bool kFold, bool kMask, int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
norm_backward_kernel(Args<T> a) {
  // In bf16 the band holds the raw g and x, from which pass 2 forms g2 and
  // xhat again; in f32 the raw copies are replaced by g2 and xhat.
  constexpr bool kRaw = sizeof(T) == 2;
  // The band (g, or g2, when keep >= 1, then x, or xhat, when keep == 2),
  // then, when keep < 2, a ring of kRing staged x and g values a thread.
  extern __shared__ float4 s_dynamic[];
  __shared__ float s_red[2][kWarps][kMaxTile];               // warps' sums
  __shared__ __align__(8) float2 s_ranks[kMaxCluster][kMaxTile];  // ranks'
  __shared__ float s_total[2][kMaxTile];
  __shared__ __align__(8) unsigned long long s_arrived;  // mbarrier

  const int tid = threadIdx.x;
  // The mbarrier on which the cluster's sums arrive. Every block of the
  // cluster must have initialised it before another writes to it: arrive
  // on the cluster barrier now, wait just before the first such write.
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     shared_address(&s_arrived))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive;" ::: "memory");

  unsigned rank, ranks;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(ranks));
  const int n = blockIdx.z;
  const int lanes = a.tile / kVec;  // a power of two
  const int slots = kThreads / lanes;
  const int lane = tid % lanes, slot = tid / lanes;
  const int ch = blockIdx.y * a.tile + lane * kVec;
  // With kVec 4, C % 4 == 0: a lane's channels are all valid or none.
  const bool active = ch < a.c;
  const int hw = a.h * a.w;
  const int q0 = min((int)rank * a.band, hw);
  const int q1 = min(q0 + a.band, hw);
  const T* xn = a.x + (size_t)n * hw * a.c + ch;
  const T* gn =
      a.g + (size_t)n * (a.h + 2 * a.pad) * (a.w + 2 * a.pad) * a.c + ch;
  T* dxn = a.dx + (size_t)n * hw * a.c + ch;
  // This thread's slot of each array: element e of its band at e * kStride.
  constexpr int kStride = kThreads * kVec;
  const size_t band_elems = (size_t)a.band * a.tile;
  T* band_g2 = reinterpret_cast<T*>(s_dynamic) + tid * kVec;
  T* band_xhat = band_g2 + band_elems;
  T* ring_x = band_g2 + a.keep * band_elems;
  T* ring_g = ring_x + kRing * kStride;
  // A thread's first element, and its step along the band: the only
  // divisions by W.
  const Cursor start{q0 + slot, (q0 + slot) / a.w, (q0 + slot) % a.w};
  const int row_step = slots / a.w, col_step = slots % a.w;

  Channels<kVec> k;
  Pack<kVec> sum_g, sum_gx;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int nc = n * a.c + ch + e;
    k.mean.v[e] = active ? a.mean[nc] : 0.f;
    k.inv.v[e] = active ? a.inv[nc] : 0.f;
    k.scale.v[e] = active ? a.scale[ch + e] : 0.f;
    k.bias.v[e] = active && kMask ? a.bias[ch + e] : 0.f;
    sum_g.v[e] = 0.f;
    sum_gx.v[e] = 0.f;
  }

  // g2 of one element from its own g, `own`, with the mirrors folded in
  // and the mask from xhat.
  auto masked = [&](const Cursor& c, Pack<kVec> own, const Pack<kVec>& xhat) {
    own = fold<kFold, kVec>(a, own, g_source<kFold>(a, gn, c), c);
    mask<kMask, kVec>(own, xhat, k, a.slope);
    return own;
  };
  // g2 and xhat of one element from x and its own source in g; added to
  // the thread's sums and kept where it fits (in bf16: the raw g, where it
  // is not in the band already).
  auto first_pass = [&](const Cursor& c, int e, Pack<kVec> xv,
                        Pack<kVec> gv) {
    const Pack<kVec> xhat = xhat_of<kVec>(xv, k);
    const Pack<kVec> g2 = masked(c, gv, xhat);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      sum_g.v[j] += g2.v[j];
      sum_gx.v[j] += g2.v[j] * xhat.v[j];
    }
    if constexpr (kRaw) {
      if (a.keep == 1) store<kVec>(band_g2 + (size_t)e * kStride, gv);
    } else {
      if (a.keep >= 1) store<kVec>(band_g2 + (size_t)e * kStride, g2);
      if (a.keep == 2) store<kVec>(band_xhat + (size_t)e * kStride, xhat);
    }
  };
  // Stage element `c` into ring slot `s` (x, and g when `with_g`); one
  // copy group an element, empty past the band, so that copy_wait's count
  // holds.
  auto stage = [&](const Cursor& c, int s, bool with_g) {
    if (active && c.q < q1) {
      copy_async<kVec>(ring_x + s * kStride, xn + (size_t)c.q * a.c);
      if (with_g) {
        copy_async<kVec>(ring_g + s * kStride, g_source<kFold>(a, gn, c));
      }
    }
    copy_commit();
  };

  // 1. Read x and g once, fold, mask, sum. Every copy a thread makes is in
  // flight at once: into the band itself when g2 and xhat stay there, else
  // kRing elements ahead through the ring.
  if (a.keep == 2) {
    if (active) {
      int e = 0;
      for (Cursor c = start; c.q < q1; ++e) {
        copy_async<kVec>(band_xhat + (size_t)e * kStride,
                         xn + (size_t)c.q * a.c);
        copy_async<kVec>(band_g2 + (size_t)e * kStride,
                         g_source<kFold>(a, gn, c));
        c.step(slots, row_step, col_step, a.w);
      }
      copy_commit();
      copy_wait<0>();
      e = 0;
      for (Cursor c = start; c.q < q1; ++e) {
        const size_t at = (size_t)e * kStride;
        first_pass(c, e, load_shared<kVec>(band_xhat + at),
                   load_shared<kVec>(band_g2 + at));
        c.step(slots, row_step, col_step, a.w);
      }
    }
  } else {
    Cursor ahead = start;
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      stage(ahead, s, true);
      ahead.step(slots, row_step, col_step, a.w);
    }
    int e = 0;
    for (Cursor c = start; active && c.q < q1; ++e) {
      copy_wait<kRing - 1>();
      const int s = e & (kRing - 1);
      first_pass(c, e, load_shared<kVec>(ring_x + s * kStride),
                 load_shared<kVec>(ring_g + s * kStride));
      stage(ahead, s, true);
      ahead.step(slots, row_step, col_step, a.w);
      c.step(slots, row_step, col_step, a.w);
    }
    copy_wait<0>();
  }

  // 2. The block's sums: threads of one lane within a warp by shuffles,
  // then the warps' rows in order.
  for (int offset = lanes; offset < 32; offset <<= 1) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      sum_g.v[j] += __shfl_xor_sync(0xffffffffu, sum_g.v[j], offset);
      sum_gx.v[j] += __shfl_xor_sync(0xffffffffu, sum_gx.v[j], offset);
    }
  }
  const int per_warp = lanes < 32 ? 32 / lanes : 1;  // slots a warp holds
  const int rows = slots / per_warp;                 // at most kWarps
  if (slot % per_warp == 0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s_red[0][slot / per_warp][lane * kVec + j] = sum_g.v[j];
      s_red[1][slot / per_warp][lane * kVec + j] = sum_gx.v[j];
    }
  }
  __syncthreads();

  // 3. The cluster's sums, the same in every block. Each block sends its
  // sums to row `rank` of every block's table (st.async, counted in bytes
  // on the receiver's mbarrier), then waits on its own mbarrier alone, and
  // adds the rows in rank order.
  asm volatile("barrier.cluster.wait;" ::: "memory");
  if (tid == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     shared_address(&s_arrived)),
                 "r"(ranks * a.tile * 8)
                 : "memory");
  }
  if (tid < a.tile) {
    float g_part = 0.f, gx_part = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) {
      if (r < rows) {
        g_part += s_red[0][r][tid];
        gx_part += s_red[1][r][tid];
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < (int)ranks) {
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
            "[%0], {%1, %2}, [%3];" ::"r"(remote_address(&s_ranks[rank][tid], r)),
            "f"(g_part), "f"(gx_part), "r"(remote_address(&s_arrived, r))
            : "memory");
      }
    }
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(shared_address(&s_arrived))
          : "memory");
    }
    float g_total = 0.f, gx_total = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < (int)ranks) {
        g_total += s_ranks[r][tid].x;
        gx_total += s_ranks[r][tid].y;
      }
    }
    s_total[0][tid] = g_total;
    s_total[1][tid] = gx_total;
    const int c_out = blockIdx.y * a.tile + tid;
    if (rank == 0 && c_out < a.c) {
      a.dbias_nc[n * a.c + c_out] = g_total;
      a.dscale_nc[n * a.c + c_out] = gx_total;
    }
  }
  __syncthreads();
  if (!active) return;

  // 4. dx of the same elements: g2 and xhat from the band where they
  // stayed; else x (keep 1) or x and g (keep 0) through the ring again,
  // with step 1's arithmetic.
  const float count = (float)hw;
  Pack<kVec> coef, mean_g, mean_gx;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    coef.v[j] = k.scale.v[j] * k.inv.v[j];
    mean_g.v[j] = s_total[0][lane * kVec + j] / count;
    mean_gx.v[j] = s_total[1][lane * kVec + j] / count;
  }
  auto write_dx = [&](const Cursor& c, const Pack<kVec>& g2,
                      const Pack<kVec>& xhat) {
    Pack<kVec> out;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      out.v[j] = coef.v[j] * (g2.v[j] - mean_g.v[j] - xhat.v[j] * mean_gx.v[j]);
    }
    store<kVec>(dxn + (size_t)c.q * a.c, out);
  };
  if (a.keep == 2) {
    int e = 0;
    for (Cursor c = start; c.q < q1; ++e) {
      const size_t at = (size_t)e * kStride;
      if constexpr (kRaw) {
        const Pack<kVec> xhat =
            xhat_of<kVec>(load_shared<kVec>(band_xhat + at), k);
        write_dx(c, masked(c, load_shared<kVec>(band_g2 + at), xhat), xhat);
      } else {
        write_dx(c, load_shared<kVec>(band_g2 + at),
                 load_shared<kVec>(band_xhat + at));
      }
      c.step(slots, row_step, col_step, a.w);
    }
    return;
  }
  // Off chip, the band is walked back from its end: what pass 1 read last
  // is the likeliest to be still in L2.
  const bool with_g = a.keep == 0;
  const int count_e = start.q < q1 ? (q1 - 1 - start.q) / slots + 1 : 0;
  const int last = count_e - 1;
  Cursor end{start.q + last * slots, (start.q + last * slots) / a.w,
             (start.q + last * slots) % a.w};
  Cursor ahead = end;
  int ahead_e = last;
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    stage(ahead_e >= 0 ? ahead : Cursor{q1, 0, 0}, s, with_g);
    ahead.back(slots, row_step, col_step, a.w);
    --ahead_e;
  }
  Cursor c = end;
  for (int e = last; e >= 0; --e) {
    copy_wait<kRing - 1>();
    const int s = (last - e) & (kRing - 1);
    const Pack<kVec> xhat =
        xhat_of<kVec>(load_shared<kVec>(ring_x + s * kStride), k);
    Pack<kVec> g2;
    if (with_g) {
      g2 = masked(c, load_shared<kVec>(ring_g + s * kStride), xhat);
    } else if constexpr (kRaw) {
      g2 = masked(c, load_shared<kVec>(band_g2 + (size_t)e * kStride), xhat);
    } else {
      g2 = load_shared<kVec>(band_g2 + (size_t)e * kStride);
    }
    write_dx(c, g2, xhat);
    // The slot is refilled only once its values are used.
    stage(ahead_e >= 0 ? ahead : Cursor{q1, 0, 0}, s, with_g);
    ahead.back(slots, row_step, col_step, a.w);
    --ahead_e;
    c.back(slots, row_step, col_step, a.w);
  }
  copy_wait<0>();
}

template <typename T>
using Kernel = void (*)(Args<T>);

int active_clusters(const void* kernel, int cluster, int smem) {
  static std::mutex lock;
  // (kernel, cluster, smem) -> count, filled on first use: the query runs
  // once per distinct launch shape, not once per launch.
  struct Entry {
    const void* kernel;
    int cluster, smem, count;
  };
  static Entry cache[64];
  static int cached = 0;
  static const void* prepared[16];
  static int n_prepared = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < cached; ++i) {
    if (cache[i].kernel == kernel && cache[i].cluster == cluster &&
        cache[i].smem == smem) {
      return cache[i].count;
    }
  }
  bool ready = false;
  for (int i = 0; i < n_prepared; ++i) ready = ready || prepared[i] == kernel;
  if (!ready) {
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
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) return -(int)e;
    if (n_prepared < 16) prepared[n_prepared++] = kernel;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = cluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  int count = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  if (e != cudaSuccess) return -(int)e;
  if (cached < 64) cache[cached++] = Entry{kernel, cluster, smem, count};
  return count;
}

// The instantiation for (fold, mask, vec); null where there is none (a
// fold comes with the mask; bf16 takes 16-byte accesses only).
template <typename T>
Kernel<T> pick_kernel(bool fold, bool mask, int vec) {
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) {
      if (fold) return mask ? norm_backward_kernel<T, true, true, 8> : nullptr;
      return mask ? norm_backward_kernel<T, false, true, 8>
                  : norm_backward_kernel<T, false, false, 8>;
    }
  } else {
    if (vec == 4) {
      if (fold) return mask ? norm_backward_kernel<T, true, true, 4> : nullptr;
      return mask ? norm_backward_kernel<T, false, true, 4>
                  : norm_backward_kernel<T, false, false, 4>;
    }
    if (vec == 1) {
      if (fold) return mask ? norm_backward_kernel<T, true, true, 1> : nullptr;
      return mask ? norm_backward_kernel<T, false, true, 1>
                  : norm_backward_kernel<T, false, false, 1>;
    }
  }
  return nullptr;
}

const void* pick_kernel(bool fold, bool mask, int vec, int esize) {
  if (esize == 4) {
    return reinterpret_cast<const void*>(pick_kernel<float>(fold, mask, vec));
  }
  if (esize == 2) {
    return reinterpret_cast<const void*>(pick_kernel<bf16>(fold, mask, vec));
  }
  return nullptr;
}

template <typename T>
cudaError_t launch_backward(const Args<T>& a, int n, bool mask, int vec,
                            int cluster, int smem, cudaStream_t stream) {
  const Kernel<T> kernel = pick_kernel<T>(a.pad > 0, mask, vec);
  const int tiles = (a.c + a.tile - 1) / a.tile;
  const long long esize = sizeof(T);
  if (kernel == nullptr || a.c % vec != 0 || a.tile < vec ||
      a.tile > kMaxTile || (a.tile & (a.tile - 1)) != 0 || cluster < 1 ||
      cluster > kMaxCluster || a.band < 1 ||
      (long long)cluster * a.band < (long long)a.h * a.w || a.keep < 0 ||
      a.keep > 2 ||
      esize * a.keep * a.band * a.tile +
              (a.keep < 2 ? 2LL * kRing * kThreads * vec * esize : 0) >
          smem ||
      tiles > 65535 || n > 65535) {
    return cudaErrorInvalidValue;
  }
  const int fits =
      active_clusters(reinterpret_cast<const void*>(kernel), cluster, smem);
  if (fits < 0) return static_cast<cudaError_t>(-fits);
  if (fits == 0) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, tiles, n);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = cluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The launch of either element type: esize 4 (f32) or 2 (bf16).
cudaError_t launch_typed(const void* x, const float* scale, const float* bias,
                         const float* mean, const float* inv, const void* g,
                         void* dx, float* dscale_nc, float* dbias_nc, int n,
                         int h, int w, int c, int pad, float slope, bool mask,
                         int vec, int tile, int cluster, int band, int smem,
                         int keep, int esize, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (esize == 4) {
    const Args<float> a{static_cast<const float*>(x),
                        static_cast<const float*>(g), mean, inv, scale, bias,
                        static_cast<float*>(dx), dscale_nc, dbias_nc, h, w, c,
                        pad, slope, tile, band, keep};
    return launch_backward(a, n, mask, vec, cluster, smem, s);
  }
  if (esize == 2) {
    const Args<bf16> a{static_cast<const bf16*>(x),
                       static_cast<const bf16*>(g), mean, inv, scale, bias,
                       static_cast<bf16*>(dx), dscale_nc, dbias_nc, h, w, c,
                       pad, slope, tile, band, keep};
    return launch_backward(a, n, mask, vec, cluster, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cg

// The plan's fields, as backward_plan returns them: vec (4 or 1 for f32, 8
// for bf16), tile, cluster, band (pixels of H*W a block), smem (bytes of
// dynamic shared memory a block), keep and esize (bytes an element of x, g
// and dx: 4 f32, 2 bf16).

// K2. x and g [N, HW, C]; dscale_nc and dbias_nc the [N, C] partials.
extern "C" int cg_instance_norm_backward(
    const void* x, const float* scale, const float* mean, const float* inv,
    const void* g, void* dx, float* dscale_nc, float* dbias_nc, int n,
    int hw, int c, int vec, int tile, int cluster, int band, int smem,
    int keep, int esize, void* stream) {
  // x viewed as [N, HW, 1, C] with no pad.
  return (int)cg::launch_typed(x, scale, nullptr, mean, inv, g, dx, dscale_nc,
                               dbias_nc, n, hw, 1, c, 0, 1.f, false, vec, tile,
                               cluster, band, smem, keep, esize, stream);
}

// K4. x [N, H, W, C]; g [N, H+2p, W+2p, C]; the rest as K2's.
extern "C" int cg_epilogue_backward(
    const void* x, const float* scale, const float* bias, const float* mean,
    const float* inv, const void* g, void* dx, float* dscale_nc,
    float* dbias_nc, int n, int h, int w, int c, int pad, float slope,
    int vec, int tile, int cluster, int band, int smem, int keep, int esize,
    void* stream) {
  return (int)cg::launch_typed(x, scale, bias, mean, inv, g, dx, dscale_nc,
                               dbias_nc, n, h, w, c, pad, slope, true, vec,
                               tile, cluster, band, smem, keep, esize, stream);
}

// How many clusters of the backward kernel for (fold, mask, vec, esize)
// the card holds at once with `cluster` blocks of `smem` dynamic bytes
// each; a negative CUDA error if the query fails. For reports: the
// launchers make the same check themselves.
extern "C" int cg_norm_backward_active_clusters(int fold, int mask, int vec,
                                                int cluster, int smem,
                                                int esize) {
  const void* kernel = cg::pick_kernel(fold != 0, mask != 0, vec, esize);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  return cg::active_clusters(kernel, cluster, smem);
}
