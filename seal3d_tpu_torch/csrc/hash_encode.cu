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
// w * g into the fp32 master gradient [total_params, F] with one vector
// atomicAdd per corner, in one pass, without materialising K2's request
// stream. Both compute in fp32 (K3 rounds its table and each g*w to bf16).
//
// What bounds them on an H100:
// - forward: 8 random 16-byte (F=4) or 8-byte (F=2) gathers per (sample,
//   level), ~50 flops of index and weight arithmetic. At T=2^19 (bucket
//   layout, 6,119,864 rows, 93.4 MiB at F=4) the table does not fit the
//   50 MB L2, so the fine hashed levels' gathers go to HBM; at T=2^15
//   (pallas layout, 8 MiB) the table stays in L2.
// - backward: 8*F fp32 atomic adds per (sample, level), into HBM-backed rows
//   at T=2^19, plus contention on the coarse dense levels (18^3 .. cells,
//   thousands of samples per entry), whose atomics serialise in L2.
//   Warp aggregation or a sort-then-reduce pass would cut that; this first
//   version does neither. The sums land in an order that changes from run
//   to run: the gradient is not bitwise reproducible (K2's is).
//
// Design: one thread per (sample, level), threads ordered level-fastest, so
// a warp covers 2 samples x 16 levels: its x loads are broadcasts, its output
// store (forward) or cotangent load (backward) is one contiguous run. Both
// kernels derive corners and weights from one __device__ function, and
// products and sums use explicit round-to-nearest intrinsics so nvcc does not
// contract them into FMAs: the kernels round like the plain PyTorch versions
// (ops/hash_encode.py) they are tested against. The hash is the reference's
// uint32 3-prime XOR with wraparound; row offsets are 64-bit.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "grid_vec.cuh"

namespace {

using grid::atomic_axpy;
using grid::axpy;
using grid::Vec;
using grid::zero;

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct HashLevels {
  long long offset[kMaxLevels];  // first table row of the level
  float scale[kMaxLevels];       // fractional interpolation scale base*g^l - 1
  float res_m1[kMaxLevels];      // resolution - 1: clamp bound of the position
  int res_m1_i[kMaxLevels];      // the same as an int: clamp bound of a corner
  uint32_t res[kMaxLevels];      // dense stride per axis
  uint32_t last[kMaxLevels];     // params_in_level - 1: hash mask, dense clamp
  int use_hash[kMaxLevels];
};

// The 8 trilinear corners of sample x at level l: global table rows and
// interpolation weights. clamp(x*scale + shift, 0, res-1), floor, corner
// clamp to res-1; hashed levels index (cx ^ cy*2654435761 ^ cz*805459861) &
// (T-1) in uint32, dense levels min(cx + cy*res + cz*res^2, size-1);
// optional smoothstep; corner c has offset (c & 1, c >> 1 & 1, c >> 2 & 1).
__device__ __forceinline__ void corners(const float* __restrict__ x3, int l,
                                        const HashLevels& lv, float shift,
                                        int smoothstep, long long row[8],
                                        float w[8]) {
  const float scale = lv.scale[l];
  const float hi = lv.res_m1[l];
  const int hi_i = lv.res_m1_i[l];
  int p0[3];
  float fr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float p = __fadd_rn(__fmul_rn(__ldg(x3 + d), scale), shift);
    p = fminf(fmaxf(p, 0.0f), hi);
    const float f0 = floorf(p);
    p0[d] = (int)f0;
    float f = __fsub_rn(p, f0);
    if (smoothstep) {
      f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
    }
    fr[d] = f;
  }
  const long long base = lv.offset[l];
  const uint32_t last = lv.last[l];
  const uint32_t res = lv.res[l];
  const bool hashed = lv.use_hash[l] != 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const uint32_t cx = (uint32_t)min(p0[0] + ox, hi_i);
    const uint32_t cy = (uint32_t)min(p0[1] + oy, hi_i);
    const uint32_t cz = (uint32_t)min(p0[2] + oz, hi_i);
    uint32_t idx;
    if (hashed) {
      idx = (cx * 1u ^ cy * 2654435761u ^ cz * 805459861u) & last;
    } else {
      idx = min(cx + cy * res + cz * res * res, last);
    }
    row[c] = base + idx;
    const float wx = ox ? fr[0] : __fsub_rn(1.0f, fr[0]);
    const float wy = oy ? fr[1] : __fsub_rn(1.0f, fr[1]);
    const float wz = oz ? fr[2] : __fsub_rn(1.0f, fr[2]);
    w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       float* __restrict__ out, long long n_items, int levels,
                       HashLevels lv, float shift, int smoothstep) {
  using V = typename Vec<F>::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const long long s = i / levels;
  const int l = (int)(i - s * levels);
  long long row[8];
  float w[8];
  corners(x + 3 * s, l, lv, shift, smoothstep, row, w);
  const V* tab = reinterpret_cast<const V*>(table);
  V acc;
  zero(acc);
#pragma unroll
  for (int c = 0; c < 8; ++c) axpy(acc, w[c], __ldg(tab + row[c]));
  reinterpret_cast<V*>(out)[i] = acc;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ g, float* __restrict__ gtab,
                       long long n_items, int levels, HashLevels lv,
                       float shift, int smoothstep) {
  using V = typename Vec<F>::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const long long s = i / levels;
  const int l = (int)(i - s * levels);
  const V gv = __ldg(reinterpret_cast<const V*>(g) + i);
  long long row[8];
  float w[8];
  corners(x + 3 * s, l, lv, shift, smoothstep, row, w);
  V* tab = reinterpret_cast<V*>(gtab);
#pragma unroll
  for (int c = 0; c < 8; ++c) atomic_axpy(tab + row[c], w[c], gv);
}

// Argument checks and the level table; returns 0 or a cudaError_t. Every
// level must lie inside the table, and a hashed level's size must be a
// power of two (its mask).
int setup(long long m, int levels, int f_dim, long long total_rows,
          const long long* offsets, const long long* sizes,
          const int* resolutions, const int* use_hash, const float* scales,
          HashLevels* lv, unsigned* blocks) {
  if (m < 0 || levels < 1 || levels > kMaxLevels || (f_dim != 2 && f_dim != 4)) {
    return (int)cudaErrorInvalidValue;
  }
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
  }
  const long long n = (m * (long long)levels + kThreads - 1) / kThreads;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
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
  HashLevels lv;
  unsigned blocks;
  int rc = setup(m, levels, f_dim, total_rows, offsets, sizes, resolutions,
                 use_hash, scales, &lv, &blocks);
  if (rc != 0 || blocks == 0) return rc;
  const long long n_items = m * (long long)levels;
  const float shift = align_corners ? 0.0f : 0.5f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    hash_encode_fwd_kernel<4><<<blocks, kThreads, 0, st>>>(
        x, table, out, n_items, levels, lv, shift, smoothstep);
  } else {
    hash_encode_fwd_kernel<2><<<blocks, kThreads, 0, st>>>(
        x, table, out, n_items, levels, lv, shift, smoothstep);
  }
  return (int)cudaGetLastError();
}

// g [m, levels*f_dim] f32 output cotangent, x and the level arrays as in the
// forward; gtab [total_rows, f_dim] f32 must hold zeros (the caller allocates
// it): gtab[offset_l + idx_c, f] += w_c * g[m, l, f] over every m, level and
// corner. Launches on `stream` and returns cudaGetLastError().
extern "C" int hash_encode_bwd(const float* x, const float* g, float* gtab,
                               long long m, int levels, int f_dim,
                               long long total_rows, const long long* offsets,
                               const long long* sizes, const int* resolutions,
                               const int* use_hash, const float* scales,
                               int align_corners, int smoothstep,
                               void* stream) {
  HashLevels lv;
  unsigned blocks;
  int rc = setup(m, levels, f_dim, total_rows, offsets, sizes, resolutions,
                 use_hash, scales, &lv, &blocks);
  if (rc != 0 || blocks == 0) return rc;
  const long long n_items = m * (long long)levels;
  const float shift = align_corners ? 0.0f : 0.5f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    hash_encode_bwd_kernel<4><<<blocks, kThreads, 0, st>>>(
        x, g, gtab, n_items, levels, lv, shift, smoothstep);
  } else {
    hash_encode_bwd_kernel<2><<<blocks, kThreads, 0, st>>>(
        x, g, gtab, n_items, levels, lv, shift, smoothstep);
  }
  return (int)cudaGetLastError();
}
