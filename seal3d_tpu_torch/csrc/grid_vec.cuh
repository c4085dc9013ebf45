// Vector helpers shared by the grid-encode kernels (halo_encode.cu,
// hash_encode.cu): the float4 / float2 row type of an F-wide table, a
// round-to-nearest multiply-add (no FMA contraction, so the kernels round
// like their plain PyTorch versions) and the atomic scatter of w * g into a
// gradient row.
#pragma once

#include <cuda_runtime.h>

// 8- and 16-byte atomicAdd on float2/float4 in global memory: sm_90 and
// CUDA 12.8 or later.
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||     \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 8))
#define GRID_VECTOR_ATOMICS 1
#else
#define GRID_VECTOR_ATOMICS 0
#endif

namespace grid {

template <int F> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float2& a) { a = make_float2(0.f, 0.f); }

// a += w * v, each product and sum rounded separately
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

// dst += w * v, atomically per element (row gradients of one corner)
__device__ __forceinline__ void atomic_axpy(float4* dst, float w, const float4& v) {
  const float4 u = make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y),
                               __fmul_rn(w, v.z), __fmul_rn(w, v.w));
#if GRID_VECTOR_ATOMICS
  atomicAdd(dst, u);
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d + 0, u.x);
  atomicAdd(d + 1, u.y);
  atomicAdd(d + 2, u.z);
  atomicAdd(d + 3, u.w);
#endif
}
__device__ __forceinline__ void atomic_axpy(float2* dst, float w, const float2& v) {
  const float2 u = make_float2(__fmul_rn(w, v.x), __fmul_rn(w, v.y));
#if GRID_VECTOR_ATOMICS
  atomicAdd(dst, u);
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d + 0, u.x);
  atomicAdd(d + 1, u.y);
#endif
}

}  // namespace grid
