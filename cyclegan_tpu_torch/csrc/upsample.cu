// Zero-skip upsample forward (NHWC) for Hopper: the 3x3/stride-2 SAME
// transposed conv -> instance norm -> ReLU -> tf-REFLECT pad(p), with f32
// activations and f32 weights (K5) or int8 weights and a per-output-channel
// scale (K6), or with bf16 activations and weights (K5 in bf16).
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
// so no product ever meets an inserted zero: 9 taps, 9 * Cin * Cout
// multiply-adds per input pixel.
//
// Bound: operations. One read of x and one write of the output against
// 2 * 9 * Cin * Cout flops a pixel: 2.4 GFLOP at either batch-1 block of
// the 256^2 generator ([1,64,64,256] -> 128, [1,128,128,128] -> 64). The
// products run on the tensor cores in split TF32: a = hi + lo, hi =
// tf32(a) and lo = tf32(a - hi), and a * b ~ lo_a * hi_b + hi_a * lo_b +
// hi_a * hi_b, so K5 issues three passes at the H100's 495 TFLOP/s of
// dense TF32 (14.6 us a block) where f32 FMAs would need 36 us at 67
// TFLOP/s. K6's weights are int8, exact in TF32 (|q| <= 127 < 2^11), so
// lo_b = 0 and two passes suffice (9.8 us). mma.sync itself reaches about
// 310 TFLOP/s of TF32 on an H100 (tools/mma_sync_rate.py), so 23 us and
// 15 us are the floors of this route.
//
// K5 in bf16 (the JAX package's bfloat16 compute, whose kernel takes its
// taps in bf16 with f32 accumulation, upsample_kernel.py:83-131): one
// m16n8k16 bf16 MMA a tap and 16 input channels, no split, 2.4 us of
// tensor-core time a block at 989 TFLOP/s. The four phases are rounded to
// bf16 in registers BEFORE the statistics (upsample_kernel.py:108-112),
// which are taken from the rounded values; the conv output is stored in
// bf16, and with it, where the caller asks (a check of the accumulation),
// its f32 values before that rounding.
//
// Accuracy: hi + lo carries 22 of a float's 24 significand bits, and the
// dropped lo_a * lo_b is 2^-22 of the product, so each product is within
// a few f32 units in the last place; the tensor cores form each product
// exactly. They round their running sum toward zero, which biases a long
// chain, so a chain spans at most two taps of one 8-deep step (6 MMAs)
// and is then added into the block's f32 accumulators with
// round-to-nearest adds: the conv output stays as near float64 as the
// plain f32 matmuls' (tests/test_torch_port_cuda.py, chip_smoke.py).
//
// Plan (ops/cuda/upsample_kernel.py upsample_plan, computed in Python and
// checked here against the constants below): a block of 8 warps owns a
// patch of 8 x 16 input pixels of one sample and a tile of 32 output
// channels, and computes all four phases of it: 512 outputs a channel.
// In bf16 the same tiling runs one k16 step a stage: the (row, shift)
// views are ldmatrix's 16 x 16 A fragments as they load, each tap's
// [16 x 8] B fragment is one ldmatrix.trans of its staged kernel rows (two
// taps an x4), staged pixels are 24 bf16 and kernel rows 80 bytes apart,
// both on distinct banks for ldmatrix; the chains are as in f32, at most
// two k16 MMAs, then an f32 add into the accumulators.
// The grid is (N * patches, Cout tiles); patches never straddle samples.
// For each 16-deep step of Cin, cp.async stages in shared memory, three
// stages deep, the patch with a one-row, one-column halo above and to the
// left (out-of-image pixels zero-filled: x[-1] = 0) and the nine taps'
// [16 x 32] slices of the kernel; one barrier a step. Warp (wm, wn) holds
// rows 4 wm .. 4 wm + 3 of the patch and channels 8 wn .. 8 wn + 7: one
// m16n8k8 tile is one patch row, the row above is the same fragment one
// row up, and the column-left view is the same rows loaded one pixel
// earlier, so ldmatrix loads each (row, shift) view once an 8-deep step,
// splits it as it loads, and all nine taps read from it; each kernel
// fragment is split once as it loads and serves the warp's four rows.
// Every warp does the same 9 taps of work. The staged pixel stride (20
// floats) and kernel row stride (40 floats or 48 bytes) put every warp's
// fragment loads on distinct banks.
//
// The norm statistics come from the GEMM's epilogue. With the tile in
// registers (K6: times kscale[co], the TPU kernel's order,
// upsample_kernel.py:198), each block reduces a (mean, M2) partial per
// channel over its patch's outputs: two passes within the thread, then
// shuffles, then the two row warps through shared memory; it then writes
// the tile to conv_out. The last block of each (sample, channel tile) to
// finish, found with an integer ticket taken after __threadfence(),
// merges the partials in patch order with Chan's formula into mean and
// inv, and sets the ticket back to 0 for the next launch. The epilogue
// kernel's apply pass (epilogue.cu) then writes y: 2 launches a call,
// conv_out written once and read once. No float atomics; every sum is
// taken in a fixed order, so two calls give bitwise-equal outputs.
#include <cstdint>
#include <type_traits>

#include "kernels.cuh"

namespace cg {
namespace {

constexpr int kThreads = 256;
constexpr int kPatchRows = 8;   // input rows of a patch
constexpr int kPatchCols = 16;  // input columns: one m16 tile a row
constexpr int kTile = 32;       // output channels of a block
constexpr int kDepth = 16;      // input channels a stage
constexpr int kStages = 3;
constexpr int kWarpRows = 4;    // patch rows of a warp
// Warps along the patch's rows and along the channel tile (8 channels a
// warp).
constexpr int kRowWarps = kPatchRows / kWarpRows;
constexpr int kColWarps = kTile / 8;
static_assert(kRowWarps * kColWarps * 32 == kThreads, "warp layout");
// Threads that merge each channel's partials in the last block.
constexpr int kMergeLanes = kThreads / kTile;
constexpr int kTaps = 9;
constexpr int kHaloCols = kPatchCols + 1;
constexpr int kPixels = (kPatchRows + 1) * kHaloCols;
// Elements of a staged pixel: f32 20 (80 bytes), bf16 24 (48 bytes).
template <typename T>
__host__ __device__ constexpr int x_stride() {
  return std::is_same<T, float>::value ? kDepth + 4 : kDepth + 8;
}
template <typename T>
__host__ __device__ constexpr int x_stage_elems() {
  return kPixels * x_stride<T>();
}
// Bytes of one staged kernel row of kTile channels: f32 rows padded to 40
// floats, bf16 rows to 40 bf16 (80 bytes), int8 rows to 48 bytes (16-byte
// aligned for cp.async).
template <typename W>
__host__ __device__ constexpr int w_row_bytes() {
  return std::is_same<W, float>::value  ? 4 * (kTile + 8)
         : std::is_same<W, bf16>::value ? 2 * (kTile + 8)
                                        : kTile + 16;
}
template <typename W>
__host__ __device__ constexpr int w_stage_bytes() {
  return kTaps * kDepth * w_row_bytes<W>();
}
template <typename T, typename W>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * ((int)sizeof(T) * x_stage_elems<T>() + w_stage_bytes<W>());
}

struct Args {
  const void* x;        // [N, H, W, Cin] of T
  const void* k;        // [3, 3, Cin, Cout] of W
  const float* kscale;  // K6 only
  void* conv_out;       // [N, 2H, 2W, Cout] of T
  float* conv_f32;      // bf16 only, optional: conv_out before its rounding
  float* part_mean;     // [N, patches, Cout]
  float* part_m2;
  int* tickets;         // [N, Cout tiles], zero between launches
  float* mean;
  float* inv;
  int h, w, cin, cout;
  int patches_w, patches;  // patches a sample: along W, in all
  float eps;
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (16 or 4); src_bytes 0 zero-fills the destination.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     shared_address(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     shared_address(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// tf32(v): v rounded to 10 mantissa bits, to nearest with ties away from
// zero, the rounding of cvt.rna.tf32.f32 for every finite v (and Inf).
// Written out, it is two integer operations; ptxas expands cvt.rna into
// four, guarding Inf and NaN inputs that these activations do not hold.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// v rounded to bf16 (to nearest even) and widened back: the value a bf16
// store of v holds.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, lane l giving
// the address of row l % 8 of matrix l / 8: the A fragment of an m16n8k8
// TF32 MMA (16 pixels x 8 channels; lane l at pixel (l & 7) + 8 ((l >> 3)
// & 1), channels 4 (l >> 4) .. + 3: 8 rows x 16 bytes are 8 rows x 4 tf32)
// or of an m16n8k16 bf16 one (the same pixels, channels 8 (l >> 4) .. + 7).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(shared_address(p))
      : "memory");
}

// Transposed 8 x 8 bf16 matrices: from a [k][n] row-major block, lane l of
// the warp gets k = 2 (l % 4), + 1 at n = l / 4 of each, the B fragment's
// layout of an m16n8k16 MMA. x4 takes rows from lanes 0-31, x2 from 0-15.
__device__ __forceinline__ void load_b4(uint32_t (&b)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(shared_address(p))
      : "memory");
}

__device__ __forceinline__ void load_b2(uint32_t (&b)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(shared_address(p))
      : "memory");
}

// d += a * b on the tensor cores, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b: the first product of a chain, from a zero accumulator.
__device__ __forceinline__ void mma_first(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// The bf16 forms: d (+)= a * b over 16 input channels, f32 accumulators.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma16_first(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// A view of one patch row: hi and lo of its A fragment.
struct View {
  uint32_t hi[4], lo[4];
};

// One tap's B fragment: hi and, for f32 weights, lo.
struct Weights {
  uint32_t hi[2], lo[2];
};

// A view from the staged (unsplit) patch, split into hi and lo.
__device__ __forceinline__ void load_view(View& v, const float* p) {
  uint32_t raw[4];
  load_a(raw, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), v.hi[i], v.lo[i]);
}

__device__ __forceinline__ void add(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

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

// Outputs a patch holds: four phases of its in-image pixels.
__device__ __forceinline__ float patch_count(const Args& a, int patch) {
  const int row0 = (patch / a.patches_w) * kPatchRows;
  const int col0 = (patch % a.patches_w) * kPatchCols;
  return 4.f * (float)(min(kPatchRows, a.h - row0) *
                       min(kPatchCols, a.w - col0));
}

// This thread's share of staging a step of Cin: the x patch with its halo
// as 16-byte chunks of a pixel (4 floats or 8 bf16), and the nine taps'
// kernel rows as 16-byte chunks (4 floats, 8 bf16 or 16 int8). Thread t
// takes chunks t, t + 256, ...; the offsets that do not depend on the step
// are computed once. kVec: one 16-byte cp.async a chunk (Cin a multiple of
// a chunk, Cout of a chunk of weights, 16-byte aligned pointers); else (f32
// activations only) a 4-byte copy a float and a plain load an int8, each
// checked on its own.
template <typename T, typename W, bool kVec>
struct Loader {
  static_assert(kVec || sizeof(T) == 4, "bf16 takes 16-byte copies only");
  static constexpr int kXElems = 16 / (int)sizeof(T);  // of a chunk
  static constexpr int kXPerPixel = kDepth / kXElems;
  static constexpr int kXChunks = kPixels * kXPerPixel;
  static constexpr int kXIters = (kXChunks + kThreads - 1) / kThreads;
  static constexpr int kWPerRow = kTile * (int)sizeof(W) / 16;
  static constexpr int kWChunks = kTaps * kDepth * kWPerRow;
  static constexpr int kWIters = (kWChunks + kThreads - 1) / kThreads;
  // Kernel rows (tap * kDepth + depth) between a thread's chunks.
  static constexpr int kWRowStep = kThreads / kWPerRow;
  static constexpr int kWElems = 16 / (int)sizeof(W);

  int x_src[kXIters];  // element offset of the chunk at c0 = 0; -1: zeros
  int x_dst;           // element offset of chunk 0 in a staged patch
  int x_c;             // the chunk's first channel within the step
  int w_src;           // element offset of chunk 0 at c0 = 0
  int w_dst;           // byte offset of chunk 0 in a staged kernel slice
  int w_ci, w_co;      // its depth within the step and first channel

  __device__ __forceinline__ Loader(const Args& a, int sample, int row0,
                                    int col0, int co0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kXIters; ++j) {
      const int pix = (tid + j * kThreads) / kXPerPixel;
      const int y = row0 - 1 + pix / kHaloCols;
      const int x = col0 - 1 + pix % kHaloCols;
      const bool in = pix < kPixels && y >= 0 && y < a.h && x >= 0 && x < a.w;
      x_src[j] = in ? ((sample * a.h + y) * a.w + x) * a.cin : -1;
    }
    x_c = kXElems * (tid % kXPerPixel);
    x_dst = (tid / kXPerPixel) * x_stride<T>() + x_c;
    const int row = tid / kWPerRow, col = (tid % kWPerRow) * kWElems;
    w_ci = row % kDepth;
    w_co = co0 + col;
    w_src = ((row / kDepth) * a.cin + w_ci) * a.cout + w_co;
    w_dst = row * w_row_bytes<W>() + col * (int)sizeof(W);
  }

  // Stage step `step` into a slot, as one cp.async group.
  __device__ __forceinline__ void load(const Args& a, T* xs,
                                       unsigned char* ws, int step) const {
    const int tid = threadIdx.x;
    const int c0 = step * kDepth;
    const T* x = static_cast<const T*>(a.x);
#pragma unroll
    for (int j = 0; j < kXIters; ++j) {
      if (tid + j * kThreads >= kXChunks) break;
      T* dst = xs + x_dst + j * (kThreads / kXPerPixel) * x_stride<T>();
      const int c = c0 + x_c;
      if constexpr (kVec) {
        const bool ok = x_src[j] >= 0 && c < a.cin;
        copy_async<16>(dst, x + (ok ? x_src[j] + c : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = x_src[j] >= 0 && c + e < a.cin;
          copy_async<4>(dst + e, x + (ok ? x_src[j] + c + e : 0), ok);
        }
      }
    }
    const W* k = static_cast<const W*>(a.k);
    const bool depth_ok = c0 + w_ci < a.cin;
#pragma unroll
    for (int j = 0; j < kWIters; ++j) {
      if (tid + j * kThreads >= kWChunks) break;
      unsigned char* dst = ws + w_dst + j * kWRowStep * w_row_bytes<W>();
      const int src = w_src + c0 * a.cout + j * (kWRowStep / kDepth) * a.cin *
                                                a.cout;
      if constexpr (kVec) {
        const bool ok = depth_ok && w_co < a.cout;
        copy_async<16>(dst, k + (ok ? src : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < kWElems; ++e) {
          const bool ok = depth_ok && w_co + e < a.cout;
          if constexpr (std::is_same<W, float>::value) {
            copy_async<4>(dst + 4 * e, k + (ok ? src + e : 0), ok);
          } else {
            reinterpret_cast<int8_t*>(dst)[e] = ok ? k[src + e] : int8_t(0);
          }
        }
      }
    }
    copy_commit();
  }
};

// T, W: activations and weights: (float, float) K5, (float, int8_t) K6,
// (bf16, bf16) K5 in bf16.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) upsample_mma_kernel(Args a) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr bool kSplitW = std::is_same<W, float>::value;  // hi and lo of b
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  constexpr int kXStride = x_stride<T>();
  constexpr int kXStage = x_stage_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // kStages staged patches
  unsigned char* ws = reinterpret_cast<unsigned char*>(xs + kStages * kXStage);
  __shared__ float s_cnt[kRowWarps][kTile], s_mean[kRowWarps][kTile],
      s_m2[kRowWarps][kTile];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kColWarps, wn = warp % kColWarps;
  const int g = lane >> 2, t4 = lane & 3;
  const int sample = blockIdx.x / a.patches;
  const int patch = blockIdx.x % a.patches;
  const int row0 = (patch / a.patches_w) * kPatchRows;
  const int col0 = (patch % a.patches_w) * kPatchCols;
  const int co0 = blockIdx.y * kTile;
  const int steps = (a.cin + kDepth - 1) / kDepth;

  const Loader<T, W, kVec> loader(a, sample, row0, col0, co0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      loader.load(a, xs + s * kXStage, ws + s * w_stage_bytes<W>(), s);
    } else {
      copy_commit();
    }
  }

  // This lane's ldmatrix row: pixel m of a view, the 16-byte chunk of
  // channels kq (4 floats or 8 bf16 a chunk).
  const int m = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int kq = (16 / (int)sizeof(T)) * (lane >> 4);
  // acc[row][phase][i]: phase ee, eo, oe, oo; i = (pixel g, channel 2 t4),
  // (g, 2 t4 + 1), (g + 8, 2 t4), (g + 8, 2 t4 + 1).
  float acc[kWarpRows][4][4];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][p][i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int slot = step % kStages;
    const T* xst = xs + slot * kXStage;
    const unsigned char* wst = ws + slot * w_stage_bytes<W>();
    copy_wait<kStages - 2>();
    // Stage `step` has landed for every thread, and every warp is done with
    // the slot the next copies overwrite.
    __syncthreads();
    if (step + kStages - 1 < steps) {
      const int next = step + kStages - 1;
      loader.load(a, xs + (next % kStages) * kXStage,
                  ws + (next % kStages) * w_stage_bytes<W>(), next);
    } else {
      copy_commit();
    }

    if constexpr (kBf16) {
      // One k16 step: each tap's B fragment from its staged rows k = lane
      // % 16 (two taps an x4: lanes 16-31 give the second tap's rows).
      uint32_t b[kTaps][2];
      const int k_row = lane & 15;
#pragma unroll
      for (int tp = 0; tp + 1 < kTaps; tp += 2) {
        uint32_t q[4];
        load_b4(q, wst + ((tp + (lane >> 4)) * kDepth + k_row) *
                             w_row_bytes<W>() + 16 * wn);
        b[tp][0] = q[0];
        b[tp][1] = q[1];
        b[tp + 1][0] = q[2];
        b[tp + 1][1] = q[3];
      }
      load_b2(b[kTaps - 1],
              wst + ((kTaps - 1) * kDepth + k_row) * w_row_bytes<W>() +
                  16 * wn);
      // Views of staged row sr (patch row sr - 1), as in f32 below.
      auto load_views = [&](int sr, uint32_t (&here)[4],
                            uint32_t (&left)[4]) {
        const int o = (sr * kHaloCols + m) * kXStride + kq;
        load_a(here, xst + o + kXStride);
        load_a(left, xst + o);
      };
      uint32_t up[4], up_left[4], here[4], left[4];
      load_views(kWarpRows * wm, up, up_left);
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        load_views(kWarpRows * wm + r + 1, here, left);
        float ee[4], ee2[4], eo[4], oe[4], oo[4];
        mma16_first(ee, up_left, b[0]);  // K00 x[p-1, q-1]
        mma16_first(eo, up, b[1]);       // K01 x[p-1, q]
        mma16_first(ee2, left, b[6]);    // K20 x[p, q-1]
        mma16_first(oe, left, b[3]);     // K10 x[p, q-1]
        mma16_first(oo, here, b[4]);     // K11 x[p, q]
        mma16(ee, up, b[2]);             // K02 x[p-1, q]
        mma16(eo, here, b[7]);           // K21 x[p, q]
        mma16(ee2, here, b[8]);          // K22 x[p, q]
        mma16(oe, here, b[5]);           // K12 x[p, q]
        add(acc[r][0], ee);
        add(acc[r][0], ee2);
        add(acc[r][1], eo);
        add(acc[r][2], oe);
        add(acc[r][3], oo);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          up[i] = here[i];
          up_left[i] = left[i];
        }
      }
    } else {
      // One 8-deep step at a time: unrolling the two would hold both
      // steps' kernel fragments at once.
#pragma unroll 1
      for (int kk = 0; kk < kDepth; kk += 8) {
        Weights b[kTaps];
#pragma unroll
        for (int tp = 0; tp < kTaps; ++tp) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int row = tp * kDepth + kk + t4 + 4 * j;
            const int col = 8 * wn + g;
            if constexpr (kSplitW) {
              const float v = reinterpret_cast<const float*>(
                  wst + row * w_row_bytes<W>())[col];
              split(v, b[tp].hi[j], b[tp].lo[j]);
            } else {
              const int8_t q = reinterpret_cast<const int8_t*>(
                  wst + row * w_row_bytes<W>())[col];
              b[tp].hi[j] = __float_as_uint((float)q);
              b[tp].lo[j] = 0u;
            }
          }
        }
        // Views of staged row sr (patch row sr - 1): `here` x[p, q] and
        // `left` x[p, q - 1]; the row above is the previous row's views.
        auto load_views = [&](int sr, View& here, View& left) {
          const int o = (sr * kHaloCols + m) * kXStride + kk + kq;
          load_view(here, xst + o + kXStride);
          load_view(left, xst + o);
        };
        View up, up_left, here, left;
        load_views(kWarpRows * wm, up, up_left);
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          load_views(kWarpRows * wm + r + 1, here, left);
          // Five chains, one a phase and ee's four taps as two, issued pass
          // by pass so that the tensor cores overlap them; each tap's passes
          // in the order lo_a * hi_b, hi_a * lo_b (K5), hi_a * hi_b.
          float ee[4], ee2[4], eo[4], oe[4], oo[4];
          mma_first(ee, up_left.lo, b[0].hi);  // K00 x[p-1, q-1]
          mma_first(eo, up.lo, b[1].hi);       // K01 x[p-1, q]
          mma_first(ee2, left.lo, b[6].hi);    // K20 x[p, q-1]
          mma_first(oe, left.lo, b[3].hi);     // K10 x[p, q-1]
          mma_first(oo, here.lo, b[4].hi);     // K11 x[p, q]
          if constexpr (kSplitW) {
            mma(ee, up_left.hi, b[0].lo);
            mma(eo, up.hi, b[1].lo);
            mma(ee2, left.hi, b[6].lo);
            mma(oe, left.hi, b[3].lo);
            mma(oo, here.hi, b[4].lo);
          }
          mma(ee, up_left.hi, b[0].hi);
          mma(eo, up.hi, b[1].hi);
          mma(ee2, left.hi, b[6].hi);
          mma(oe, left.hi, b[3].hi);
          mma(oo, here.hi, b[4].hi);
          mma(ee, up.lo, b[2].hi);             // K02 x[p-1, q]
          mma(eo, here.lo, b[7].hi);           // K21 x[p, q]
          mma(ee2, here.lo, b[8].hi);          // K22 x[p, q]
          mma(oe, here.lo, b[5].hi);           // K12 x[p, q]
          if constexpr (kSplitW) {
            mma(ee, up.hi, b[2].lo);
            mma(eo, here.hi, b[7].lo);
            mma(ee2, here.hi, b[8].lo);
            mma(oe, here.hi, b[5].lo);
          }
          mma(ee, up.hi, b[2].hi);
          mma(eo, here.hi, b[7].hi);
          mma(ee2, here.hi, b[8].hi);
          mma(oe, here.hi, b[5].hi);
          add(acc[r][0], ee);
          add(acc[r][0], ee2);
          add(acc[r][1], eo);
          add(acc[r][2], oe);
          add(acc[r][3], oo);
          up = here;
          up_left = left;
        }
      }
    }
  }
  copy_wait<0>();

  // Epilogue. The tile (scaled for K6; rounded to bf16 in bf16) stays in
  // registers while each channel's (count, mean, M2) over this thread's
  // in-image outputs is taken in two passes, merged across the block and
  // published with the block's ticket; the stores to conv_out go out after
  // that, so that the fence waits for the partials alone and the ticket's
  // round trip overlaps the stores.
  const int co = co0 + 8 * wn + 2 * t4;
  const int h2 = 2 * a.h, w2 = 2 * a.w;
  // Visit each in-image output pair (channels co, co + 1) of this thread:
  // f(r, p, half, address of the pair in an [N, 2H, 2W, Cout] tensor).
  auto each_output = [&](auto&& f) {
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const int py = row0 + kWarpRows * wm + r;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = col0 + g + 8 * half;
          if (py >= a.h || px >= a.w) continue;
          const int oy = 2 * py + (p >> 1), ox = 2 * px + (p & 1);
          f(r, p, half, (((size_t)sample * h2 + oy) * w2 + ox) * a.cout + co);
        }
      }
    }
  };
  if constexpr (kInt8) {
    const float ks[2] = {co < a.cout ? a.kscale[co] : 0.f,
                         co + 1 < a.cout ? a.kscale[co + 1] : 0.f};
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][p][i] *= ks[i & 1];
  }
  if constexpr (kBf16) {
    if (a.conv_f32 != nullptr) {
      each_output([&](int r, int p, int half, size_t o) {
        if (co < a.cout) a.conv_f32[o] = acc[r][p][2 * half];
        if (co + 1 < a.cout) a.conv_f32[o + 1] = acc[r][p][2 * half + 1];
      });
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][p][i] = round_bf16(acc[r][p][i]);
  }
  float cnt = 0.f, sum[2] = {0.f, 0.f};
  each_output([&](int r, int p, int half, size_t) {
    cnt += 1.f;
    sum[0] += acc[r][p][2 * half];
    sum[1] += acc[r][p][2 * half + 1];
  });
  float mean[2], m2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) mean[j] = cnt > 0.f ? sum[j] / cnt : 0.f;
  each_output([&](int r, int p, int half, size_t) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float d = acc[r][p][2 * half + j] - mean[j];
      m2[j] += d * d;
    }
  });
  // Lanes of one t4 hold the same two channels: merge them into g == 0.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float n = cnt, mu = mean[j], q = m2[j];
#pragma unroll
    for (int offset = 16; offset >= 4; offset >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, offset);
      const float mb = __shfl_down_sync(0xffffffffu, mu, offset);
      const float qb = __shfl_down_sync(0xffffffffu, q, offset);
      merge(n, mu, q, nb, mb, qb);
    }
    if (g == 0) {
      s_cnt[wm][8 * wn + 2 * t4 + j] = n;
      s_mean[wm][8 * wn + 2 * t4 + j] = mu;
      s_m2[wm][8 * wn + 2 * t4 + j] = q;
    }
  }
  __syncthreads();
  const int gi = sample * gridDim.y + blockIdx.y;
  if (tid < kTile && co0 + tid < a.cout) {
    float n = s_cnt[0][tid], mu = s_mean[0][tid], q = s_m2[0][tid];
#pragma unroll
    for (int i = 1; i < kRowWarps; ++i) {
      merge(n, mu, q, s_cnt[i][tid], s_mean[i][tid], s_m2[i][tid]);
    }
    const size_t o = ((size_t)sample * a.patches + patch) * a.cout + co0 + tid;
    a.part_mean[o] = mu;
    a.part_m2[o] = q;
    __threadfence();
  }
  __syncthreads();
  int ticket = 0;
  if (tid == 0) ticket = atomicAdd(a.tickets + gi, 1);

  T* conv_out = static_cast<T*>(a.conv_out);
  each_output([&](int r, int p, int half, size_t o) {
    const float v0 = acc[r][p][2 * half], v1 = acc[r][p][2 * half + 1];
    T* out = conv_out + o;
    if (co + 1 < a.cout && (a.cout & 1) == 0) {
      if constexpr (kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
      }
    } else {
      if (co < a.cout) out[0] = T(v0);
      if (co + 1 < a.cout) out[1] = T(v1);
    }
  });
  if (tid == 0) s_last = ticket == a.patches - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The last block of (sample, channel tile): kMergeLanes lanes a channel
  // merge every kMergeLanes-th patch in order, then each other in a fixed
  // tree.
  const int c = tid / kMergeLanes, lane_c = tid % kMergeLanes;
  float n = 0.f, mu = 0.f, q = 0.f;
  if (co0 + c < a.cout) {
    // Eight partials in flight at a time, merged in patch order.
    constexpr int kBatch = 8;
    for (int p0 = lane_c; p0 < a.patches; p0 += kMergeLanes * kBatch) {
      float pm[kBatch], pq[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int pt = p0 + kMergeLanes * u;
        const size_t o = ((size_t)sample * a.patches + pt) * a.cout + co0 + c;
        pm[u] = pt < a.patches ? __ldcg(a.part_mean + o) : 0.f;
        pq[u] = pt < a.patches ? __ldcg(a.part_m2 + o) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int pt = p0 + kMergeLanes * u;
        if (pt < a.patches) merge(n, mu, q, patch_count(a, pt), pm[u], pq[u]);
      }
    }
  }
#pragma unroll
  for (int offset = kMergeLanes / 2; offset > 0; offset >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, offset);
    const float mb = __shfl_down_sync(0xffffffffu, mu, offset);
    const float qb = __shfl_down_sync(0xffffffffu, q, offset);
    merge(n, mu, q, nb, mb, qb);
  }
  if (lane_c == 0 && co0 + c < a.cout) {
    const size_t o = (size_t)sample * a.cout + co0 + c;
    a.mean[o] = mu;
    a.inv[o] = 1.0f / sqrtf(q / (float)(4 * a.h * a.w) + a.eps);
  }
  if (tid == 0) a.tickets[gi] = 0;
}

// Let the kernel take its dynamic shared memory, once per instantiation
// (its size is fixed by T and W): at the first launch, before a CUDA graph
// can capture one.
template <typename T, typename W, bool kWide>
cudaError_t prepare_upsample() {
  static const cudaError_t e = cudaFuncSetAttribute(
      upsample_mma_kernel<T, W, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, W>());
  return e;
}

template <typename T, typename W>
cudaError_t upsample_forward(const Args& a, int n, const float* scale,
                             const float* bias, void* y, int pad, int vec,
                             int patch_rows, int patch_cols, int tile,
                             int depth, int stages, int smem,
                             cudaStream_t s) {
  const int tiles = (a.cout + kTile - 1) / kTile;
  const int patches_h = (a.h + kPatchRows - 1) / kPatchRows;
  // bf16 takes 16-byte copies only: 8 channels of x, of the kernel rows
  // and (for the apply pass) of the output.
  const bool typed = std::is_same<T, float>::value
                         ? (vec == 4 || vec == 1)
                         : (vec == 8 && a.cin % 8 == 0 && a.cout % 8 == 0);
  if (!typed || patch_rows != kPatchRows || patch_cols != kPatchCols ||
      tile != kTile || depth != kDepth || stages != kStages ||
      smem != smem_bytes<T, W>() ||
      a.patches_w != (a.w + kPatchCols - 1) / kPatchCols ||
      a.patches != patches_h * a.patches_w ||
      (long long)n * a.patches >= (1LL << 31) || tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  void (*kernel)(Args) = upsample_mma_kernel<T, W, true>;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    if (vec == 1) kernel = upsample_mma_kernel<T, W, false>;
    err = vec == 1 ? prepare_upsample<T, W, false>()
                   : prepare_upsample<T, W, true>();
  } else {
    err = prepare_upsample<T, W, true>();
  }
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n * a.patches, tiles), kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_norm_act_pad<T>(static_cast<const T*>(a.conv_out), a.mean,
                                a.inv, scale, bias, static_cast<T*>(y), n,
                                2 * a.h, 2 * a.w, a.cout, pad, 0.f, s);
}

Args make_args(const void* x, const void* kernel, const float* kernel_scale,
               void* conv_out, float* conv_f32, float* part_mean,
               float* part_m2, int* tickets, float* mean, float* inv, int h,
               int w, int cin, int cout, float eps) {
  const int patches_w = (w + kPatchCols - 1) / kPatchCols;
  return Args{x, kernel, kernel_scale, conv_out, conv_f32, part_mean,
              part_m2, tickets, mean, inv, h, w, cin, cout, patches_w,
              patches_w * ((h + kPatchRows - 1) / kPatchRows), eps};
}

}  // namespace
}  // namespace cg

// conv_out is the [N, 2H, 2W, Cout] pre-norm output, y the
// [N, 2H+2p, 2W+2p, Cout] one, both of the activations' type; part_mean and
// part_m2 [N, patches, Cout] scratch; tickets [N, Cout tiles] int32, zero
// on entry and on return; mean and inv [N, Cout]. The plan's fields, as
// upsample_plan returns them: vec (4 or 1 for f32, 8 for bf16), patch rows
// and columns, channel tile, depth step, stages, dynamic shared memory
// bytes and esize (bytes an element of x, the kernel, conv_out and y: 4
// f32, 2 bf16).

// K5: x and kernel [3, 3, Cin, Cout] f32 or bf16; conv_f32 null, or (bf16)
// an f32 [N, 2H, 2W, Cout] for conv_out before its rounding.
extern "C" int cg_upsample_forward(
    const void* x, const void* kernel, const float* scale, const float* bias,
    void* conv_out, float* conv_f32, void* y, float* part_mean,
    float* part_m2, int* tickets, float* mean, float* inv, int n, int h,
    int w, int cin, int cout, int pad, float eps, int vec, int patch_rows,
    int patch_cols, int tile, int depth, int stages, int smem, int esize,
    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (esize == 4 && conv_f32 == nullptr) {
    const cg::Args a = cg::make_args(x, kernel, nullptr, conv_out, nullptr,
                                     part_mean, part_m2, tickets, mean, inv,
                                     h, w, cin, cout, eps);
    return (int)cg::upsample_forward<float, float>(
        a, n, scale, bias, y, pad, vec, patch_rows, patch_cols, tile, depth,
        stages, smem, s);
  }
  if (esize == 2) {
    const cg::Args a = cg::make_args(x, kernel, nullptr, conv_out, conv_f32,
                                     part_mean, part_m2, tickets, mean, inv,
                                     h, w, cin, cout, eps);
    return (int)cg::upsample_forward<cg::bf16, cg::bf16>(
        a, n, scale, bias, y, pad, vec, patch_rows, patch_cols, tile, depth,
        stages, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K6: x f32, kernel_q int8 [3, 3, Cin, Cout], kernel_scale f32 [Cout];
// esize 4.
extern "C" int cg_upsample_int8_forward(
    const float* x, const int8_t* kernel_q, const float* kernel_scale,
    const float* scale, const float* bias, float* conv_out, float* y,
    float* part_mean, float* part_m2, int* tickets, float* mean, float* inv,
    int n, int h, int w, int cin, int cout, int pad, float eps, int vec,
    int patch_rows, int patch_cols, int tile, int depth, int stages, int smem,
    int esize, void* stream) {
  if (esize != 4) return (int)cudaErrorInvalidValue;
  const cg::Args a = cg::make_args(x, kernel_q, kernel_scale, conv_out,
                                   nullptr, part_mean, part_m2, tickets, mean,
                                   inv, h, w, cin, cout, eps);
  return (int)cg::upsample_forward<float, int8_t>(
      a, n, scale, bias, y, pad, vec, patch_rows, patch_cols, tile, depth,
      stages, smem, static_cast<cudaStream_t>(stream));
}
