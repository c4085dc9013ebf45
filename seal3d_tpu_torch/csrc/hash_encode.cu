// K3 and K2: multiresolution encode over the 'hash' grid type, forward and
// backward, in any level layout.
//
// Replaces two Pallas TPU kernels of the JAX package:
// - K3, seal3d_tpu/ops/pallas/hash_encode.py: the forward
//   `hash_encode_fused` -> `_fused_fwd_impl` (kernel body `_make_fwd_kernel`)
//   and the backward `_fused_bwd` (`_make_bwd_kernel`), the 'pallas'
//   backend's encode over levels padded to T;
// - K2, seal3d_tpu/ops/pallas/bucket_grad.py: `bucket_scatter_add`, the
//   'bucket' backend's table gradient over native, 8-aligned level sizes
//   (seal3d_tpu/ops/hashgrid.py `_bucket_encode_bwd`).
// The TPU kernels route every lookup through one-hot bf16 MXU matmuls over a
// VMEM-resident [L, T/128, F*128] stack (K3), or sort the [M*L*8, F] request
// stream and walk 4096-entry buckets with one-hot matmuls (K2), because a
// TPU has no gather and no atomics. None of that is carried over. One kernel
// pair serves both layouts: the layout is data, the per-level offset, size,
// resolution, hash flag and scale that HashGridConfig.level_params gives,
// passed by value. The forward gathers the 8 trilinear corners of a sample
// straight from the fp32 master table [total_params, F]; the backward scatters
// w * g into the fp32 master gradient [total_params, F] with vector
// atomicAdds, in one pass, without materialising K2's request stream. Both
// compute in fp32 (K3 rounds its table and each g*w to bf16).
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W; device times of
// chip_smoke.py's phase 17, F=4, 16 levels; PERF.md section 6 has the
// tables). Not the bytes of the roofline bound (x and features once each and
// the table sectors the samples touch: 0.08 ms for a 786,432-sample chunk)
// but the 32-byte sectors of the table, 8 a (sample, level), and where they
// are served from:
// - 'pallas' layout, T=2^15: the 8 MiB table stays in the 50 MB L2. A real
//   800x800 render chunk (786,432 samples in ray order) asks for 100 M
//   corners, 36-42 M sectors after merging within warps of 32 consecutive
//   samples: 0.25-0.29 ms at the 4.6 TB/s the L2 serves them at.
// - 'bucket' layout, T=2^19: 5 dense levels (5.4 MiB) and 11 hashed levels
//   of 8 MiB, 93.4 MiB in all. Real samples touch about 54 MB of it (1.7 M
//   sectors, a train step's 73,728 packed samples and a render chunk
//   alike), which the L2 mostly holds: one thread per (sample, level) with
//   all 16 levels live took 0.372 ms on the chunk, as at T=2^15. Random
//   points touch all of it: 1.51 ms at 2^20 points, 0.78 at T=2^15.
// - backward: the same sectors as vector atomics in L2, onto a gradient
//   that was just zero-filled (0.03 ms of the times below at T=2^19).
//   Samples of one ray in one cell serialise on its 8 rows: one atomic per
//   (sample, level, corner) took 0.28 ms on the real bucket step, 3.65 ms
//   on a render chunk's samples, 4.22 ms on 2^20 random points (all 93 MiB
//   of gradient live at once: most atomics reach device memory).
// With the design below: bucket step 0.064 / 0.163 ms forward / backward
// (0.064 / 0.280 before), bucket chunk 0.347 ms (0.372), the chunk's samples
// backward 1.26 ms (3.65), 2^20 random points backward 1.78 ms (4.22);
// pallas step 0.037 / 0.083 ms (0.038 / 0.134), pallas chunk 0.256 ms
// (0.368); a grid update's query chunk (131,072 rows, F=2) 0.062 ms at
// T=2^19 and 0.047 at T=2^15 (0.064, 0.063). 2^20 random points lose in the
// forward where the table is L2-resident (T=2^15: 0.90 ms against 0.78).
//
// Design. Two forwards and one backward.
// - The tiles (large forwards, every backward). A block of kThreads threads
//   owns a tile of consecutive samples and one GROUP of consecutive levels;
//   a thread owns one sample, a warp 32 consecutive samples, and walks the
//   group's levels; kSplit warps share a sample group and take every
//   kSplit-th level each (fewer where the smallest group has fewer levels;
//   more, with a shorter tile, for a launch of few blocks). The 32 lanes of
//   a gather address one level at 32 neighbouring samples of a ray, which
//   share most of their sectors. x is loaded once per tile, coalesced, into
//   shared memory, and the tile's features ([tile, group's levels * F] fp32)
//   pass through shared memory, its row pitch odd in F-wide vectors: the
//   forward stores, and the backward loads its cotangent, with coalesced
//   F-wide vector accesses.
// - The direct forward (small forwards): one thread per (sample, level),
//   level-fastest, no tile, no barrier, as the kernels were before the
//   tiles. The tiles gain from neighbouring samples; a train step packs the
//   samples of 4096 random rays of many views, few of which share a cell,
//   and there the tile's two barriers cost 6-10% (0.064 -> 0.068 ms at
//   T=2^19, 0.037 -> 0.041 at T=2^15; random points of that count 7-18%).
//   The kernel cannot see the order of its samples, only their count, and
//   on the repo's paths the count tells them apart: kDirectPairs.
// - Level groups, in the backward: consecutive levels whose table rows take
//   at most kGroupBytes (16 MiB) together. Blocks are numbered
//   group-slowest, so the blocks resident at one time scatter into one group
//   (two while one drains): its rows stay in L2 however many samples and
//   levels there are (random 2^20 points 4.06 -> 1.77 ms, the real step
//   0.188 -> 0.158 ms). The price is x read once per group and the
//   cotangent read in column slabs (32 bytes a row for a group of two F=4
//   levels). The forward's kernel walks a group too, and its launch keeps
//   all levels in one: grouped, a real chunk took 0.43 ms against 0.34,
//   because real samples fit the L2 anyway, and only random points gained
//   (2^20: 1.51 -> 1.01 ms). At T=2^15 the whole table is one group.
// - The backward sums within a warp before the atomics: consecutive
//   lanes in the same cell form a run, each run is reduced with shuffles and
//   its first lane makes one vector atomicAdd per corner. On a hashed level
//   equal rows do not prove equal cells, so the integer cell coordinates are
//   compared. A warp without a run pays three shuffles and a ballot.
// The tile, run and segmented-sum helpers are shared with halo_encode.cu
// (grid_tile.cuh). The layout is data: the per-level offset, size,
// resolution, hash flag and scale that HashGridConfig.level_params gives,
// passed by value. Both kernels derive corners and weights from one
// __device__ function, and products and sums use explicit round-to-nearest
// intrinsics so nvcc does not contract them into FMAs: each (sample, level)
// result is the sum over corners 0..7 in that order, rounded like the plain
// PyTorch version (ops/hash_encode.py), whatever the grouping. The hash is
// the reference's uint32 3-prime XOR with wraparound. The backward's sums
// land in an order that changes from run to run (atomics): the gradient is
// not bitwise reproducible (K2's is).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

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
constexpr int kDirectThreads = 256;  // of the small forward
constexpr int kSplit = 4;  // warps per 32-sample group, level-interleaved
// A launch of fewer blocks than this (about four rounds on 132 SMs) is cut
// into shorter tiles with more warps per sample group.
constexpr long long kFewBlocks = 1024;
// Table bytes of one level group of the backward: what the blocks resident
// at one time scatter into stays in L2.
constexpr long long kGroupBytes = 16ll << 20;
// A forward of at most this many (sample, level) pairs takes the direct
// kernel, a larger one the tiles: at 16 levels a train step's packed samples
// (73,728 rows of random rays) lie below it, every query chunk of a grid
// update (131,072 rows) and every chunk of an 800x800 view (98,304 to 786,432
// rows of neighbouring rays) above it.
constexpr long long kDirectPairs = 81920ll * 16;

struct HashLevels {
  long long offset[kMaxLevels];  // first table row of the level
  float scale[kMaxLevels];       // fractional interpolation scale base*g^l - 1
  float res_m1[kMaxLevels];      // resolution - 1: clamp bound of the position
  int res_m1_i[kMaxLevels];      // the same as an int: clamp bound of a corner
  uint32_t res[kMaxLevels];      // dense stride per axis
  uint32_t last[kMaxLevels];     // params_in_level - 1: hash mask, dense clamp
  int use_hash[kMaxLevels];
  int first[kMaxLevels + 1];     // group g holds levels first[g]..first[g+1]-1
};

// The 8 trilinear corners of sample x3 at level l: level-local table rows,
// interpolation weights and the integer cell (the coordinates of corner 0).
// clamp(x*scale + shift, 0, res-1), floor, corner clamp to res-1; hashed
// levels index (cx ^ cy*2654435761 ^ cz*805459861) & (T-1) in uint32, dense
// levels min(cx + cy*res + cz*res^2, size-1); optional smoothstep; corner c
// has offset (c & 1, c >> 1 & 1, c >> 2 & 1).
__device__ __forceinline__ void corners(const float x3[3], int l,
                                        const HashLevels& lv, float shift,
                                        int smoothstep, uint32_t row[8],
                                        float w[8], int cell[3]) {
  const float scale = lv.scale[l];
  const float hi = lv.res_m1[l];
  const int hi_i = lv.res_m1_i[l];
  float fr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float p = __fadd_rn(__fmul_rn(x3[d], scale), shift);
    p = fminf(fmaxf(p, 0.0f), hi);
    const float f0 = floorf(p);
    cell[d] = (int)f0;
    float f = __fsub_rn(p, f0);
    if (smoothstep) {
      f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
    }
    fr[d] = f;
  }
  const uint32_t last = lv.last[l];
  const uint32_t res = lv.res[l];
  const bool hashed = lv.use_hash[l] != 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const uint32_t cx = (uint32_t)min(cell[0] + ox, hi_i);
    const uint32_t cy = (uint32_t)min(cell[1] + oy, hi_i);
    const uint32_t cz = (uint32_t)min(cell[2] + oz, hi_i);
    if (hashed) {
      row[c] = (cx * 1u ^ cy * 2654435761u ^ cz * 805459861u) & last;
    } else {
      row[c] = min(cx + cy * res + cz * res * res, last);
    }
    const float wx = ox ? fr[0] : __fsub_rn(1.0f, fr[0]);
    const float wy = oy ? fr[1] : __fsub_rn(1.0f, fr[1]);
    const float wz = oz ? fr[2] : __fsub_rn(1.0f, fr[2]);
    w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
}

// Shared memory of one block: the feature tile [tile][pitch] of F-wide
// vectors (pitch = tile_pitch(levels of the largest group)), then x
// [tile][3].
size_t smem_bytes(int group_levels, int f_dim, int tile) {
  return (size_t)tile * tile_pitch(group_levels) * f_dim * sizeof(float) +
         (size_t)tile * 3 * sizeof(float);
}

// The tiled forward: block (blockIdx.x, blockIdx.y) = (sample tile, level
// group), as in the backward; its launch has one group of all the levels.
template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       float* __restrict__ out, long long m, int levels,
                       HashLevels lv, float shift, int smoothstep, int tile) {
  using V = typename Vec<F>::T;
  extern __shared__ float4 smem[];
  const int l0 = lv.first[blockIdx.y];
  const int nl = lv.first[blockIdx.y + 1] - l0;
  const int pitch = tile_pitch(nl);
  V* feats = reinterpret_cast<V*>(smem);
  float* xs = reinterpret_cast<float*>(feats + tile * pitch);
  const long long s0 = (long long)blockIdx.x * tile;
  const int n = load_positions(x, s0, m, tile, xs);
  __syncthreads();
  const int split = kThreads / tile;
  const int t = threadIdx.x % tile;
  if (t < n) {
    const float x3[3] = {xs[3 * t], xs[3 * t + 1], xs[3 * t + 2]};
    for (int j = threadIdx.x / tile; j < nl; j += split) {
      uint32_t row[8];
      float w[8];
      int cell[3];
      corners(x3, l0 + j, lv, shift, smoothstep, row, w, cell);
      const V* tab = reinterpret_cast<const V*>(table) + lv.offset[l0 + j];
      V acc;
      zero(acc);
#pragma unroll
      for (int c = 0; c < 8; ++c) axpy(acc, w[c], __ldg(tab + row[c]));
      feats[t * pitch + j] = acc;
    }
  }
  __syncthreads();
  // the tile's columns of the group out, one F-wide vector per thread and turn
  V* outv = reinterpret_cast<V*>(out) + s0 * levels + l0;
  for (int i = threadIdx.x; i < n * nl; i += kThreads) {
    const int r = i / nl, c = i - r * nl;
    outv[(long long)r * levels + c] = feats[r * pitch + c];
  }
}

// The forward of a small launch: one thread per (sample, level),
// level-fastest, so a warp's output store is one contiguous run; no tile, no
// barrier.
template <int F>
__global__ void __launch_bounds__(kDirectThreads)
hash_encode_fwd_direct_kernel(const float* __restrict__ x,
                              const float* __restrict__ table,
                              float* __restrict__ out, long long n_items,
                              int levels, HashLevels lv, float shift,
                              int smoothstep) {
  using V = typename Vec<F>::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const long long s = i / levels;
  const int l = (int)(i - s * levels);
  const float x3[3] = {__ldg(x + 3 * s), __ldg(x + 3 * s + 1),
                       __ldg(x + 3 * s + 2)};
  uint32_t row[8];
  float w[8];
  int cell[3];
  corners(x3, l, lv, shift, smoothstep, row, w, cell);
  const V* tab = reinterpret_cast<const V*>(table) + lv.offset[l];
  V acc;
  zero(acc);
#pragma unroll
  for (int c = 0; c < 8; ++c) axpy(acc, w[c], __ldg(tab + row[c]));
  reinterpret_cast<V*>(out)[i] = acc;
}

// The backward: block (blockIdx.x, blockIdx.y) = (sample tile, level group);
// blocks are handed out x-fastest, so the groups follow one another in time.
template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ g, float* __restrict__ gtab,
                       long long m, int levels, HashLevels lv, float shift,
                       int smoothstep, int tile) {
  using V = typename Vec<F>::T;
  extern __shared__ float4 smem[];
  const int l0 = lv.first[blockIdx.y];
  const int nl = lv.first[blockIdx.y + 1] - l0;
  const int pitch = tile_pitch(nl);
  V* feats = reinterpret_cast<V*>(smem);
  float* xs = reinterpret_cast<float*>(feats + tile * pitch);
  const long long s0 = (long long)blockIdx.x * tile;
  const int n = load_positions(x, s0, m, tile, xs);
  // the tile's cotangent columns of the group in, one F-wide vector per
  // thread and turn
  const V* gv = reinterpret_cast<const V*>(g) + s0 * levels + l0;
  for (int i = threadIdx.x; i < n * nl; i += kThreads) {
    const int r = i / nl, c = i - r * nl;
    feats[r * pitch + c] = __ldg(gv + (long long)r * levels + c);
  }
  __syncthreads();

  const int split = kThreads / tile;
  const int t = threadIdx.x % tile;
  const unsigned lane = threadIdx.x & 31;
  const bool ok = t < n;
  float x3[3] = {0.0f, 0.0f, 0.0f};
  if (ok) {
    x3[0] = xs[3 * t];
    x3[1] = xs[3 * t + 1];
    x3[2] = xs[3 * t + 2];
  }
  for (int j = threadIdx.x / tile; j < nl; j += split) {
    uint32_t row[8];
    float w[8];
    int cell[3];
    corners(x3, l0 + j, lv, shift, smoothstep, row, w, cell);
    V gl;
    zero(gl);
    if (ok) gl = feats[t * pitch + j];
    V* tab = reinterpret_cast<V*>(gtab) + lv.offset[l0 + j];
    // A run: consecutive lanes in one cell. Equal rows would not prove it
    // on a hashed level (two cells may share a row, and then not all 8), so
    // the integer cells are compared. A lane past the tile's end joins no
    // run.
    const int c0 = ok ? cell[0] : -1 - (int)lane;
    const int p0 = __shfl_up_sync(kFullMask, c0, 1);
    const int p1 = __shfl_up_sync(kFullMask, cell[1], 1);
    const int p2 = __shfl_up_sync(kFullMask, cell[2], 1);
    const bool head = lane == 0 || c0 != p0 || cell[1] != p1 || cell[2] != p2;
    scatter_runs(tab, row, w, gl, ok, head, lane);
  }
}

struct Launch {
  HashLevels lv;
  dim3 blocks;  // (sample tiles, level groups)
  size_t smem;
  int tile;     // samples per block: kThreads / warps per sample group
  bool direct;  // a small forward: the direct kernel
};

// Argument checks, the level table, the level groups and the tile; returns
// 0 or a cudaError_t. Every level must lie inside the table, and a hashed
// level's size must be a power of two (its mask). The backward's consecutive
// levels form a group while their table rows take at most kGroupBytes
// together; the forward keeps all levels in one group.
int setup(long long m, int levels, int f_dim, long long total_rows,
          const long long* offsets, const long long* sizes,
          const int* resolutions, const int* use_hash, const float* scales,
          bool forward, Launch* la) {
  if (m < 0 || levels < 1 || levels > kMaxLevels || (f_dim != 2 && f_dim != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long group_bytes = forward ? LLONG_MAX : kGroupBytes;
  HashLevels* lv = &la->lv;
  int groups = 0, fewest = levels, most = 0;
  long long held = 0;
  lv->first[0] = 0;
  for (int l = 0; l < levels; ++l) {
    const long long n = sizes[l];
    if (offsets[l] < 0 || n < 1 || n > (1LL << 32) ||
        offsets[l] + n > total_rows || resolutions[l] < 1 ||
        (use_hash[l] && (n & (n - 1)) != 0)) {
      return (int)cudaErrorInvalidValue;
    }
    lv->offset[l] = offsets[l];
    lv->scale[l] = scales[l];
    lv->res_m1[l] = (float)(resolutions[l] - 1);
    lv->res_m1_i[l] = resolutions[l] - 1;
    lv->res[l] = (uint32_t)resolutions[l];
    lv->last[l] = (uint32_t)(n - 1);
    lv->use_hash[l] = use_hash[l] ? 1 : 0;
    const long long bytes = n * f_dim * (long long)sizeof(float);
    if (l > lv->first[groups] && held + bytes > group_bytes) {
      lv->first[++groups] = l;
      held = 0;
    }
    held += bytes;
  }
  lv->first[++groups] = levels;
  for (int g = 0; g < groups; ++g) {
    const int nl = lv->first[g + 1] - lv->first[g];
    fewest = nl < fewest ? nl : fewest;
    most = nl > most ? nl : most;
  }
  la->tile = kThreads / pick_split(m, fewest, groups, kThreads, kSplit,
                                   kFewBlocks);
  const long long tiles = (m + la->tile - 1) / la->tile;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  la->blocks = dim3((unsigned)tiles, (unsigned)groups);
  la->smem = smem_bytes(most, f_dim, la->tile);
  la->direct = forward && m * levels <= kDirectPairs;
  return 0;
}

}  // namespace

// x [m, 3] f32 in [0, 1], table [total_rows, f_dim] f32, out [m, levels*f_dim]
// f32. offsets/sizes (int64), resolutions/use_hash (int32) and scales (f32)
// are HOST arrays of `levels` entries: HashGridConfig.level_params. The
// position is x*scale + (align_corners ? 0 : 0.5). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int hash_encode_fwd(const float* x, const float* table, float* out,
                               long long m, int levels, int f_dim,
                               long long total_rows, const long long* offsets,
                               const long long* sizes, const int* resolutions,
                               const int* use_hash, const float* scales,
                               int align_corners, int smoothstep,
                               void* stream) {
  Launch la;
  int rc = setup(m, levels, f_dim, total_rows, offsets, sizes, resolutions,
                 use_hash, scales, true, &la);
  if (rc != 0 || la.blocks.x == 0) return rc;
  const float shift = align_corners ? 0.0f : 0.5f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (la.direct) {
    const long long n_items = m * (long long)levels;
    const unsigned blocks =
        (unsigned)((n_items + kDirectThreads - 1) / kDirectThreads);
    if (f_dim == 4) {
      hash_encode_fwd_direct_kernel<4><<<blocks, kDirectThreads, 0, st>>>(
          x, table, out, n_items, levels, la.lv, shift, smoothstep);
    } else {
      hash_encode_fwd_direct_kernel<2><<<blocks, kDirectThreads, 0, st>>>(
          x, table, out, n_items, levels, la.lv, shift, smoothstep);
    }
    return (int)cudaGetLastError();
  }
  if (f_dim == 4) {
    if ((rc = allow_smem(hash_encode_fwd_kernel<4>, la.smem)) != 0) return rc;
    hash_encode_fwd_kernel<4><<<la.blocks, kThreads, la.smem, st>>>(
        x, table, out, m, levels, la.lv, shift, smoothstep, la.tile);
  } else {
    if ((rc = allow_smem(hash_encode_fwd_kernel<2>, la.smem)) != 0) return rc;
    hash_encode_fwd_kernel<2><<<la.blocks, kThreads, la.smem, st>>>(
        x, table, out, m, levels, la.lv, shift, smoothstep, la.tile);
  }
  return (int)cudaGetLastError();
}

// g [m, levels*f_dim] f32 output cotangent, x and the level arrays as in
// the forward; gtab [total_rows, f_dim] f32 must hold zeros
// (the caller allocates it): gtab[offset_l + idx_c, f] += w_c * g[m, l, f]
// over every m, level and corner. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hash_encode_bwd(const float* x, const float* g, float* gtab,
                               long long m, int levels, int f_dim,
                               long long total_rows, const long long* offsets,
                               const long long* sizes, const int* resolutions,
                               const int* use_hash, const float* scales,
                               int align_corners, int smoothstep,
                               void* stream) {
  Launch la;
  int rc = setup(m, levels, f_dim, total_rows, offsets, sizes, resolutions,
                 use_hash, scales, false, &la);
  if (rc != 0 || la.blocks.x == 0) return rc;
  const float shift = align_corners ? 0.0f : 0.5f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    if ((rc = allow_smem(hash_encode_bwd_kernel<4>, la.smem)) != 0) return rc;
    hash_encode_bwd_kernel<4><<<la.blocks, kThreads, la.smem, st>>>(
        x, g, gtab, m, levels, la.lv, shift, smoothstep, la.tile);
  } else {
    if ((rc = allow_smem(hash_encode_bwd_kernel<2>, la.smem)) != 0) return rc;
    hash_encode_bwd_kernel<2><<<la.blocks, kThreads, la.smem, st>>>(
        x, g, gtab, m, levels, la.lv, shift, smoothstep, la.tile);
  }
  return (int)cudaGetLastError();
}
