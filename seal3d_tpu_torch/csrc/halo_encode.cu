// K1: multiresolution trilinear encode over the 'wrap' grid type, forward
// and backward, over all levels of a table or over a range of them (the
// per-shard program of the level-sharded encode).
//
// Replaces the Pallas TPU kernels of seal3d_tpu/ops/pallas/halo_encode.py:
// the forward `halo_encode_fused` -> `_fwd_impl_arrs` (kernel body
// `_make_fwd_kernel`) and the backward `_bwd` -> `_bwd_impl` (kernel body
// `_make_bwd_kernel`), and, with a level range, what `halo_encode_sharded`
// -> `_halo_encode_arrs` runs on each shard. The TPU kernels store each 4^3
// block's 5^3 halo in one 128-lane row, fetch it with a one-hot bf16 matmul
// and scatter the gradient back with the transposed one-hot matmul into
// level-blocked VMEM windows, because a TPU has no fast gather or scatter.
// None of that is carried over: the forward gathers the 8 trilinear corners
// straight from the fp32 master table [L*T, F], and the backward scatters
// w * g into the fp32 master-table gradient [L*T, F] with atomics (no
// halo_expand transpose). Both compute in fp32.
//
// What bounds them on an H100, at the -O point (L=16, T=2^15, F=4: an 8 MB
// table that stays resident in the 50 MB L2). Not the bytes of the roofline
// bound (table, x and features once each: 0.066 ms at 786,432 samples) but
// - forward: the 32-byte L2 sectors of the fine levels. Launched one level
//   alone on the packed samples of a real 800x800 render chunk (786,432
//   samples in ray order), levels 10-15 take 34-46 us each, with this design
//   and with one thread per (sample, level) alike: along a ray neighbouring
//   samples share cells only up to about level 9. The six finest levels'
//   distinct sectors (6 x 8 x 32 B a sample) alone take ~0.25 ms. A coarse
//   row that many samples share is served by L1 in either thread order
//   (levels 0-7: 14-17 us each with a thread per (sample, level)), as long
//   as the fine levels' sectors do not push it out: all 16 levels in one
//   launch took that design 0.511 ms, 0.09 ms more than its 16 launches.
// - backward: the atomics into L2, 8 a (sample, level). Many samples in one
//   coarse cell serialise on its 8 rows: one thread per (sample, level) with
//   one atomic per corner took 22.7 us on level 0 against 8.7 us on level 15
//   on a real train step's 73,728 samples, and 1.84 ms on a Seal
//   pretraining batch (2^19 points inside a few coarse cells).
// With the design below the chunk's forward takes 0.430 ms (0.511 before),
// the step's backward 0.065 ms (0.090), the Seal batch 0.117 / 0.340 ms
// forward / backward (0.148 / 1.841); the step's forward (0.036 ms) and 2^20
// random points (0.768 / 1.190 ms) stay where they were. NVIDIA H100 80GB
// HBM3, 700 W, device times of chip_smoke.py's phase 16; PERF.md section 6
// has the tables.
//
// Design. A block of kThreads threads owns a tile of consecutive samples
// and every level of its range. A thread owns one sample; a warp owns 32
// consecutive samples and walks the levels. kSplit warps share a sample
// group and take every kSplit-th level each; a range of fewer levels takes
// fewer warps per group and a longer tile, a small batch more warps and a
// shorter tile, so that its blocks still fill the card. The 32 lanes of one
// gather thus address ONE level table at 32 neighbouring samples: samples
// along a ray that sit in the same or adjacent cells hit the same sectors in
// one request.
// - x and valid are loaded once per tile, coalesced, into shared memory; a
//   tile whose samples are all invalid (a packed tail) writes zeros
//   (forward) or returns (backward) without touching the table.
// - The tile's features ([tile, n*F] fp32, one contiguous run of `out`
//   when rows are packed) pass through shared memory, its row pitch padded
//   to an odd number of F-wide vectors so the per-lane row accesses spread
//   over the banks: the forward stores the tile, and the backward loads its
//   cotangent tile, with coalesced F-wide vector accesses.
// - The backward sums within a warp before it issues atomics: consecutive
//   lanes whose samples lie in the same cell (equal rows of corners 0 and 7)
//   form a run, each run is reduced with shuffles and its first lane issues
//   one vector atomicAdd per corner. A warp without such a run (fine levels,
//   unordered points) skips the reduction after two shuffles and a ballot.
// Level scales and resolutions arrive by value in the kernel parameters.
// Both kernels derive corners and weights from one __device__ function, and
// products and sums use explicit round-to-nearest intrinsics so nvcc does not
// contract them into FMAs: each (sample, level) result is the sum over
// corners 0..7 in that order, rounded like the plain PyTorch version
// (ops/halo_encode.py), whatever the level range. The backward's sums land
// in an order that changes from run to run (atomics), so its result is not
// bitwise reproducible.

#include <cuda_runtime.h>
#include <climits>

#include "grid_tile.cuh"
#include "grid_vec.cuh"

namespace {

using grid::allow_smem;
using grid::axpy;
using grid::kFullMask;
using grid::load_positions;
using grid::pick_split;
using grid::scatter_runs;
using grid::tile_pitch;
using grid::Vec;
using grid::zero;

constexpr int kMaxLevels = 32;
constexpr int kThreads = 512;
constexpr int kSplit = 4;  // warps per 32-sample group, level-interleaved
// A batch of fewer tiles than this (about four rounds of blocks on 132 SMs)
// is cut into shorter tiles with more warps per sample group.
constexpr long long kFewBlocks = 1024;

struct LevelParams {
  float scale[kMaxLevels];   // fractional interpolation scale base*g^l - 1
  float res_m1[kMaxLevels];  // resolution - 1: clamp bound of the position
  int res_m1_i[kMaxLevels];  // the same as an int: clamp bound of a corner
};

// The 8 trilinear corners of sample x3 at level l: level-local table rows
// and interpolation weights. clamp(x*scale + 0.5, 0, res-1), floor, corner
// clamp to res-1, wrap & (P-1), optional smoothstep; corner c has offset
// (c & 1, c >> 1 & 1, c >> 2 & 1).
__device__ __forceinline__ void corners(const float x3[3], int l,
                                        const LevelParams& lp, int log2p,
                                        int smoothstep, int row[8],
                                        float w[8]) {
  const float scale = lp.scale[l];
  const float hi = lp.res_m1[l];
  const int hi_i = lp.res_m1_i[l];
  const int pmask = (1 << log2p) - 1;
  int p0[3];
  float fr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float p = __fadd_rn(__fmul_rn(x3[d], scale), 0.5f);
    p = fminf(fmaxf(p, 0.0f), hi);
    const float f0 = floorf(p);
    p0[d] = (int)f0;
    float f = __fsub_rn(p, f0);
    if (smoothstep) {
      f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
    }
    fr[d] = f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const int cx = min(p0[0] + ox, hi_i) & pmask;
    const int cy = min(p0[1] + oy, hi_i) & pmask;
    const int cz = min(p0[2] + oz, hi_i) & pmask;
    const float wx = ox ? fr[0] : __fsub_rn(1.0f, fr[0]);
    const float wy = oy ? fr[1] : __fsub_rn(1.0f, fr[1]);
    const float wz = oz ? fr[2] : __fsub_rn(1.0f, fr[2]);
    w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
    row[c] = (((cx << log2p) + cy) << log2p) + cz;
  }
}

// Shared memory of one block: the feature tile [tile][pitch] of F-wide
// vectors (pitch = tile_pitch(levels)), then x [tile][3] and valid [tile].
size_t smem_bytes(int levels, int f_dim, int tile) {
  return (size_t)tile * tile_pitch(levels) * f_dim * sizeof(float) +
         (size_t)tile * 3 * sizeof(float) + tile;
}

// Loads the tile's x and valid into shared memory (all threads call it; it
// ends in a barrier). Returns the tile's sample count through n and whether
// any of its samples is valid.
__device__ __forceinline__ bool load_samples(
    const float* __restrict__ x, const unsigned char* __restrict__ valid,
    long long s0, long long m, int tile, float* xs, unsigned char* vs,
    int* n) {
  *n = load_positions(x, s0, m, tile, xs);
  int any = 0;
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    const unsigned char v =
        i < *n ? (valid == nullptr ? 1 : __ldg(valid + s0 + i)) : 0;
    vs[i] = v;
    any |= v;
  }
  return __syncthreads_or(any) != 0;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
halo_encode_fwd_kernel(const float* __restrict__ x,
                       const unsigned char* __restrict__ valid,
                       const float* __restrict__ table,
                       float* __restrict__ out, long long m, int levels,
                       int log2p, long long t_rows, LevelParams lp,
                       int smoothstep, long long stride_v, int tile) {
  using V = typename Vec<F>::T;
  extern __shared__ float4 smem[];
  const int pitch = tile_pitch(levels);
  V* feats = reinterpret_cast<V*>(smem);
  float* xs = reinterpret_cast<float*>(feats + tile * pitch);
  unsigned char* vs = reinterpret_cast<unsigned char*>(xs + 3 * tile);
  const long long s0 = (long long)blockIdx.x * tile;
  const int split = kThreads / tile;
  int n;
  const bool any = load_samples(x, valid, s0, m, tile, xs, vs, &n);
  if (any) {
    const int t = threadIdx.x % tile;
    if (t < n) {
      const bool ok = vs[t] != 0;
      const float x3[3] = {xs[3 * t], xs[3 * t + 1], xs[3 * t + 2]};
      for (int l = threadIdx.x / tile; l < levels; l += split) {
        V acc;
        zero(acc);
        if (ok) {
          int row[8];
          float w[8];
          corners(x3, l, lp, log2p, smoothstep, row, w);
          const V* tab =
              reinterpret_cast<const V*>(table) + (long long)l * t_rows;
#pragma unroll
          for (int c = 0; c < 8; ++c) axpy(acc, w[c], __ldg(tab + row[c]));
        }
        feats[t * pitch + l] = acc;
      }
    }
    __syncthreads();
  }
  // the tile's rows out, one F-wide vector per thread and turn
  V* outv = reinterpret_cast<V*>(out) + s0 * stride_v;
  for (int i = threadIdx.x; i < n * levels; i += kThreads) {
    const int r = i / levels, c = i - r * levels;
    V v;
    zero(v);
    if (any) v = feats[r * pitch + c];
    outv[r * stride_v + c] = v;
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
halo_encode_bwd_kernel(const float* __restrict__ x,
                       const unsigned char* __restrict__ valid,
                       const float* __restrict__ g, float* __restrict__ gtab,
                       long long m, int levels, int log2p, long long t_rows,
                       LevelParams lp, int smoothstep, long long stride_v,
                       int tile) {
  using V = typename Vec<F>::T;
  extern __shared__ float4 smem[];
  const int pitch = tile_pitch(levels);
  V* feats = reinterpret_cast<V*>(smem);
  float* xs = reinterpret_cast<float*>(feats + tile * pitch);
  unsigned char* vs = reinterpret_cast<unsigned char*>(xs + 3 * tile);
  const long long s0 = (long long)blockIdx.x * tile;
  const int split = kThreads / tile;
  int n;
  if (!load_samples(x, valid, s0, m, tile, xs, vs, &n)) return;  // adds nothing
  // the tile's cotangent rows in, one F-wide vector per thread and turn
  const V* gv = reinterpret_cast<const V*>(g) + s0 * stride_v;
  for (int i = threadIdx.x; i < n * levels; i += kThreads) {
    const int r = i / levels, c = i - r * levels;
    feats[r * pitch + c] = __ldg(gv + r * stride_v + c);
  }
  __syncthreads();

  const int t = threadIdx.x % tile;
  const unsigned lane = threadIdx.x & 31;
  const bool ok = vs[t] != 0;  // vs is 0 beyond the tile's n samples
  const float x3[3] = {xs[3 * t], xs[3 * t + 1], xs[3 * t + 2]};
  for (int l = threadIdx.x / tile; l < levels; l += split) {
    int row[8];
    float w[8];
    corners(x3, l, lp, log2p, smoothstep, row, w);
    V gl;
    zero(gl);
    if (ok) gl = feats[t * pitch + l];
    V* tab = reinterpret_cast<V*>(gtab) + (long long)l * t_rows;
    // A run: consecutive lanes in one cell. Rows of corners 0 and 7 fix
    // the (wrapped, clamped) coordinates of all 8. An invalid lane joins
    // no run.
    const int r0 = ok ? row[0] : -1 - (int)lane;
    const int p0 = __shfl_up_sync(kFullMask, r0, 1);
    const int p7 = __shfl_up_sync(kFullMask, row[7], 1);
    const bool head = lane == 0 || r0 != p0 || row[7] != p7;
    scatter_runs(tab, row, w, gl, ok, head, lane);
  }
}

struct Launch {
  LevelParams lp;
  int log2p;
  unsigned blocks;
  size_t smem;
  long long stride_v;  // row stride of the feature tensor in F-wide vectors
  int tile;            // samples per block: kThreads / warps per sample group
};

// Shared argument checks and level table; returns 0 or a cudaError_t.
int setup(long long m, int levels, int f_dim, int period, long long t_rows,
          const float* scales, const int* resolutions, long long row_stride,
          Launch* la) {
  if (m < 0 || levels < 1 || levels > kMaxLevels || (f_dim != 2 && f_dim != 4) ||
      period < 2 || (period & (period - 1)) != 0 ||
      (long long)period * period * period != t_rows) {
    return (int)cudaErrorInvalidValue;
  }
  if (row_stride == 0) row_stride = (long long)levels * f_dim;
  if (row_stride < (long long)levels * f_dim || row_stride % f_dim != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < levels; ++l) {
    la->lp.scale[l] = scales[l];
    la->lp.res_m1[l] = (float)(resolutions[l] - 1);
    la->lp.res_m1_i[l] = resolutions[l] - 1;
  }
  la->log2p = 0;
  while ((1 << la->log2p) < period) ++la->log2p;
  la->tile = kThreads / pick_split(m, levels, 1, kThreads, kSplit, kFewBlocks);
  const long long n = (m + la->tile - 1) / la->tile;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  la->blocks = (unsigned)n;
  la->smem = smem_bytes(levels, f_dim, la->tile);
  la->stride_v = row_stride / f_dim;
  return 0;
}

}  // namespace

// x [m, 3] f32, valid [m] bool (or null = all valid). `table` points at the
// first level of the range: [levels*t_rows, f_dim] f32; scales/resolutions
// are HOST arrays of the range's `levels` entries. `out` points at the
// range's first column of row 0 of an f32 feature tensor whose rows lie
// `row_stride` floats apart (0 = packed, levels*f_dim): the kernel writes
// out[s*row_stride + l*f_dim + f]. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int halo_encode_fwd(const float* x, const unsigned char* valid,
                               const float* table, float* out, long long m,
                               int levels, int f_dim, int period,
                               long long t_rows, const float* scales,
                               const int* resolutions, int smoothstep,
                               void* stream, long long row_stride) {
  Launch la;
  int rc = setup(m, levels, f_dim, period, t_rows, scales, resolutions,
                 row_stride, &la);
  if (rc != 0 || la.blocks == 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    if ((rc = allow_smem(halo_encode_fwd_kernel<4>, la.smem)) != 0) return rc;
    halo_encode_fwd_kernel<4><<<la.blocks, kThreads, la.smem, st>>>(
        x, valid, table, out, m, levels, la.log2p, t_rows, la.lp, smoothstep,
        la.stride_v, la.tile);
  } else {
    if ((rc = allow_smem(halo_encode_fwd_kernel<2>, la.smem)) != 0) return rc;
    halo_encode_fwd_kernel<2><<<la.blocks, kThreads, la.smem, st>>>(
        x, valid, table, out, m, levels, la.log2p, t_rows, la.lp, smoothstep,
        la.stride_v, la.tile);
  }
  return (int)cudaGetLastError();
}

// g: the output cotangent, addressed like `out` of the forward (first
// column of the range, rows `row_stride` floats apart, 0 = packed); x and
// valid as in the forward; gtab [levels*t_rows, f_dim] f32, the gradient of
// the range's table, must hold zeros (the caller allocates it):
// gtab[l*T + row, f] += w * g[s, l, f] over every valid s, level and corner.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int halo_encode_bwd(const float* x, const unsigned char* valid,
                               const float* g, float* gtab, long long m,
                               int levels, int f_dim, int period,
                               long long t_rows, const float* scales,
                               const int* resolutions, int smoothstep,
                               void* stream, long long row_stride) {
  Launch la;
  int rc = setup(m, levels, f_dim, period, t_rows, scales, resolutions,
                 row_stride, &la);
  if (rc != 0 || la.blocks == 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    if ((rc = allow_smem(halo_encode_bwd_kernel<4>, la.smem)) != 0) return rc;
    halo_encode_bwd_kernel<4><<<la.blocks, kThreads, la.smem, st>>>(
        x, valid, g, gtab, m, levels, la.log2p, t_rows, la.lp, smoothstep,
        la.stride_v, la.tile);
  } else {
    if ((rc = allow_smem(halo_encode_bwd_kernel<2>, la.smem)) != 0) return rc;
    halo_encode_bwd_kernel<2><<<la.blocks, kThreads, la.smem, st>>>(
        x, valid, g, gtab, m, levels, la.log2p, t_rows, la.lp, smoothstep,
        la.stride_v, la.tile);
  }
  return (int)cudaGetLastError();
}

// 1 when the library was built with vector (float2/float4) atomics.
extern "C" int halo_encode_vector_atomics() { return GRID_VECTOR_ATOMICS; }
