// K1 forward: multiresolution trilinear encode over the 'wrap' grid type.
//
// Replaces the Pallas TPU kernel seal3d_tpu/ops/pallas/halo_encode.py
// (`halo_encode_fused` -> `_fwd_impl_arrs`, kernel body `_make_fwd_kernel`).
// The TPU kernel stores each 4^3 block's 5^3 halo in one 128-lane row and
// fetches it with a one-hot bf16 matmul, because a TPU has no fast gather.
// None of that is carried over: this kernel gathers the 8 trilinear corners
// straight from the fp32 master table [L*T, F] and computes in fp32.
//
// What bounds it on an H100: random 16-byte (F=4) or 8-byte (F=2) gathers,
// 8 per (sample, level), from a table of L*T*F*4 bytes (8 MB at the -O point:
// L=16, T=2^15, F=4) that stays resident in the 50 MB L2. Per (sample, level)
// it moves 8 table rows in and one F-wide row out; the arithmetic is ~40 flops.
//
// Design: one thread per (sample, level), threads ordered level-fastest, so a
// warp covers 2 samples x 16 levels: its x loads are broadcasts, its output
// store is one contiguous 32 x F x 4-byte run, and each corner fetch is one
// vector load (float4 / float2) through the read-only path. Level scales and
// resolutions arrive by value in the kernel parameters. Products and sums use
// explicit round-to-nearest intrinsics so nvcc does not contract them into
// FMAs: the kernel then rounds like the plain PyTorch version
// (ops/halo_encode.py), which it is tested against.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct LevelParams {
  float scale[kMaxLevels];   // fractional interpolation scale base*g^l - 1
  float res_m1[kMaxLevels];  // resolution - 1: clamp bound of the position
  int res_m1_i[kMaxLevels];  // the same as an int: clamp bound of a corner
};

template <int F> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float2& a) { a = make_float2(0.f, 0.f); }

__device__ __forceinline__ void axpy(float4& a, float w, const float4& v) {
  a.x = __fadd_rn(a.x, __fmul_rn(w, v.x));
  a.y = __fadd_rn(a.y, __fmul_rn(w, v.y));
  a.z = __fadd_rn(a.z, __fmul_rn(w, v.z));
  a.w = __fadd_rn(a.w, __fmul_rn(w, v.w));
}
__device__ __forceinline__ void axpy(float2& a, float w, const float2& v) {
  a.x = __fadd_rn(a.x, __fmul_rn(w, v.x));
  a.y = __fadd_rn(a.y, __fmul_rn(w, v.y));
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
    const float scale = lp.scale[l];
    const float hi = lp.res_m1[l];
    const int hi_i = lp.res_m1_i[l];
    const int pmask = (1 << log2p) - 1;
    int p0[3];
    float fr[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float p = __fadd_rn(__fmul_rn(__ldg(x + 3 * s + d), scale), 0.5f);
      p = fminf(fmaxf(p, 0.0f), hi);
      const float f0 = floorf(p);
      p0[d] = (int)f0;
      float f = __fsub_rn(p, f0);
      if (smoothstep) {
        f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
      }
      fr[d] = f;
    }
    const V* tab = reinterpret_cast<const V*>(table) + (long long)l * t_rows;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
      const int cx = min(p0[0] + ox, hi_i) & pmask;
      const int cy = min(p0[1] + oy, hi_i) & pmask;
      const int cz = min(p0[2] + oz, hi_i) & pmask;
      const float wx = ox ? fr[0] : __fsub_rn(1.0f, fr[0]);
      const float wy = oy ? fr[1] : __fsub_rn(1.0f, fr[1]);
      const float wz = oz ? fr[2] : __fsub_rn(1.0f, fr[2]);
      const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
      const int row = (((cx << log2p) + cy) << log2p) + cz;
      axpy(acc, w, __ldg(tab + row));
    }
  }
  reinterpret_cast<V*>(out)[i] = acc;
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
  if (m < 0 || levels < 1 || levels > kMaxLevels || (f_dim != 2 && f_dim != 4) ||
      period < 2 || (period & (period - 1)) != 0 ||
      (long long)period * period * period != t_rows) {
    return (int)cudaErrorInvalidValue;
  }
  LevelParams lp;
  for (int l = 0; l < levels; ++l) {
    lp.scale[l] = scales[l];
    lp.res_m1[l] = (float)(resolutions[l] - 1);
    lp.res_m1_i[l] = resolutions[l] - 1;
  }
  int log2p = 0;
  while ((1 << log2p) < period) ++log2p;
  const long long n_items = m * (long long)levels;
  if (n_items == 0) return 0;
  const long long blocks = (n_items + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    halo_encode_fwd_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(
        x, valid, table, out, n_items, levels, log2p, t_rows, lp, smoothstep);
  } else {
    halo_encode_fwd_kernel<2><<<(unsigned)blocks, kThreads, 0, st>>>(
        x, valid, table, out, n_items, levels, log2p, t_rows, lp, smoothstep);
  }
  return (int)cudaGetLastError();
}
