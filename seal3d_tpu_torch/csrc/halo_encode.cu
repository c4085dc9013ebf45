// K1: multiresolution trilinear encode over the 'wrap' grid type, forward
// and backward.
//
// Replaces the Pallas TPU kernels of seal3d_tpu/ops/pallas/halo_encode.py:
// the forward `halo_encode_fused` -> `_fwd_impl_arrs` (kernel body
// `_make_fwd_kernel`) and the backward `_bwd` -> `_bwd_impl` (kernel body
// `_make_bwd_kernel`). The TPU kernels store each 4^3 block's 5^3 halo in
// one 128-lane row, fetch it with a one-hot bf16 matmul and scatter the
// gradient back with the transposed one-hot matmul into level-blocked VMEM
// windows, because a TPU has no fast gather or scatter. None of that is
// carried over: the forward gathers the 8 trilinear corners straight from
// the fp32 master table [L*T, F], and the backward scatters w * g into the
// fp32 master-table gradient [L*T, F] with atomics (no halo_expand
// transpose). Both compute in fp32.
//
// What bounds them on an H100, at the -O point (L=16, T=2^15, F=4: an 8 MB
// table that stays resident in the 50 MB L2):
// - forward: random 16-byte (F=4) or 8-byte (F=2) gathers, 8 per (sample,
//   level); per (sample, level) it moves 8 table rows in and one F-wide row
//   out; the arithmetic is ~40 flops.
// - backward: 8*F fp32 atomic adds per (sample, level) into L2 (one vector
//   atomic per corner where the toolkit has them for sm_90), plus
//   contention on the coarse levels, where a 16^3 or 32^3 level maps
//   thousands of samples of a batch onto the same few thousand rows and
//   their atomics serialise in L2. Warp aggregation or a sort-then-reduce
//   pass would cut that; this first version does neither.
//
// Design: one thread per (sample, level), threads ordered level-fastest, so
// a warp covers 2 samples x 16 levels: its x loads are broadcasts, its
// output store (forward) or cotangent load (backward) is one contiguous
// 32 x F x 4-byte run, and each corner access is one vector load or atomic.
// Level scales and resolutions arrive by value in the kernel parameters.
// Both kernels derive corners and weights from one __device__ function, and
// products and sums use explicit round-to-nearest intrinsics so nvcc does not
// contract them into FMAs: the kernels then round like the plain PyTorch
// versions (ops/halo_encode.py) they are tested against. The backward's sums
// still land in an order that changes from run to run (atomics), so its
// result is not bitwise reproducible.

#include <cuda_runtime.h>
#include <climits>

#include "grid_vec.cuh"

namespace {

using grid::atomic_axpy;
using grid::axpy;
using grid::Vec;
using grid::zero;

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct LevelParams {
  float scale[kMaxLevels];   // fractional interpolation scale base*g^l - 1
  float res_m1[kMaxLevels];  // resolution - 1: clamp bound of the position
  int res_m1_i[kMaxLevels];  // the same as an int: clamp bound of a corner
};

// The 8 trilinear corners of sample x at level l: level-local table rows
// and interpolation weights. clamp(x*scale + 0.5, 0, res-1), floor, corner
// clamp to res-1, wrap & (P-1), optional smoothstep; corner c has offset
// (c & 1, c >> 1 & 1, c >> 2 & 1).
__device__ __forceinline__ void corners(const float* __restrict__ x3, int l,
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
    float p = __fadd_rn(__fmul_rn(__ldg(x3 + d), scale), 0.5f);
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

template <int F>
__global__ void __launch_bounds__(kThreads)
halo_encode_fwd_kernel(const float* __restrict__ x,
                       const unsigned char* __restrict__ valid,
                       const float* __restrict__ table,
                       float* __restrict__ out, long long n_items, int levels,
                       int log2p, long long t_rows, LevelParams lp,
                       int smoothstep) {
  using V = typename Vec<F>::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const long long s = i / levels;
  const int l = (int)(i - s * levels);
  V acc;
  zero(acc);
  if (valid == nullptr || valid[s]) {
    int row[8];
    float w[8];
    corners(x + 3 * s, l, lp, log2p, smoothstep, row, w);
    const V* tab = reinterpret_cast<const V*>(table) + (long long)l * t_rows;
#pragma unroll
    for (int c = 0; c < 8; ++c) axpy(acc, w[c], __ldg(tab + row[c]));
  }
  reinterpret_cast<V*>(out)[i] = acc;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
halo_encode_bwd_kernel(const float* __restrict__ x,
                       const unsigned char* __restrict__ valid,
                       const float* __restrict__ g, float* __restrict__ gtab,
                       long long n_items, int levels, int log2p,
                       long long t_rows, LevelParams lp, int smoothstep) {
  using V = typename Vec<F>::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const long long s = i / levels;
  if (valid != nullptr && !valid[s]) return;  // invalid rows add nothing
  const int l = (int)(i - s * levels);
  const V gv = __ldg(reinterpret_cast<const V*>(g) + i);
  int row[8];
  float w[8];
  corners(x + 3 * s, l, lp, log2p, smoothstep, row, w);
  V* tab = reinterpret_cast<V*>(gtab) + (long long)l * t_rows;
#pragma unroll
  for (int c = 0; c < 8; ++c) atomic_axpy(tab + row[c], w[c], gv);
}

// Shared argument checks and level table; returns 0 or a cudaError_t.
int setup(long long m, int levels, int f_dim, int period, long long t_rows,
          const float* scales, const int* resolutions, LevelParams* lp,
          int* log2p, unsigned* blocks) {
  if (m < 0 || levels < 1 || levels > kMaxLevels || (f_dim != 2 && f_dim != 4) ||
      period < 2 || (period & (period - 1)) != 0 ||
      (long long)period * period * period != t_rows) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < levels; ++l) {
    lp->scale[l] = scales[l];
    lp->res_m1[l] = (float)(resolutions[l] - 1);
    lp->res_m1_i[l] = resolutions[l] - 1;
  }
  *log2p = 0;
  while ((1 << *log2p) < period) ++*log2p;
  const long long n = (m * (long long)levels + kThreads - 1) / kThreads;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return 0;
}

}  // namespace

// x [m, 3] f32, valid [m] bool (or null = all valid), table [levels*t_rows,
// f_dim] f32, out [m, levels*f_dim] f32; scales/resolutions are HOST arrays of
// `levels` entries. Launches on `stream` and returns cudaGetLastError().
extern "C" int halo_encode_fwd(const float* x, const unsigned char* valid,
                               const float* table, float* out, long long m,
                               int levels, int f_dim, int period,
                               long long t_rows, const float* scales,
                               const int* resolutions, int smoothstep,
                               void* stream) {
  LevelParams lp;
  int log2p;
  unsigned blocks;
  int rc = setup(m, levels, f_dim, period, t_rows, scales, resolutions, &lp,
                 &log2p, &blocks);
  if (rc != 0 || blocks == 0) return rc;
  const long long n_items = m * (long long)levels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    halo_encode_fwd_kernel<4><<<blocks, kThreads, 0, st>>>(
        x, valid, table, out, n_items, levels, log2p, t_rows, lp, smoothstep);
  } else {
    halo_encode_fwd_kernel<2><<<blocks, kThreads, 0, st>>>(
        x, valid, table, out, n_items, levels, log2p, t_rows, lp, smoothstep);
  }
  return (int)cudaGetLastError();
}

// g [m, levels*f_dim] f32 output cotangent, x and valid as in the forward;
// gtab [levels*t_rows, f_dim] f32 must hold zeros (the caller allocates it):
// gtab[l*T + row, f] += w * g[m, l, f] over every valid m, level and corner.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int halo_encode_bwd(const float* x, const unsigned char* valid,
                               const float* g, float* gtab, long long m,
                               int levels, int f_dim, int period,
                               long long t_rows, const float* scales,
                               const int* resolutions, int smoothstep,
                               void* stream) {
  LevelParams lp;
  int log2p;
  unsigned blocks;
  int rc = setup(m, levels, f_dim, period, t_rows, scales, resolutions, &lp,
                 &log2p, &blocks);
  if (rc != 0 || blocks == 0) return rc;
  const long long n_items = m * (long long)levels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    halo_encode_bwd_kernel<4><<<blocks, kThreads, 0, st>>>(
        x, valid, g, gtab, n_items, levels, log2p, t_rows, lp, smoothstep);
  } else {
    halo_encode_bwd_kernel<2><<<blocks, kThreads, 0, st>>>(
        x, valid, g, gtab, n_items, levels, log2p, t_rows, lp, smoothstep);
  }
  return (int)cudaGetLastError();
}

// 1 when the library was built with vector (float2/float4) atomics.
extern "C" int halo_encode_vector_atomics() { return GRID_VECTOR_ATOMICS; }
