// Vector helpers shared by the grid-encode kernels (halo_encode.cu,
// hash_encode.cu): the float4 / float2 row type of an F-wide table, a
// round-to-nearest multiply-add (no FMA contraction, so the kernels round
// like their plain PyTorch versions), the atomic scatter of w * g into a
// gradient row, and the warp shuffle of a row.
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

// w * v, each product rounded on its own
__device__ __forceinline__ float4 scaled(float w, const float4& v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z),
                     __fmul_rn(w, v.w));
}
__device__ __forceinline__ float2 scaled(float w, const float2& v) {
  return make_float2(__fmul_rn(w, v.x), __fmul_rn(w, v.y));
}

__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ void add(float2& a, const float2& b) {
  a.x += b.x; a.y += b.y;
}

// the value of the lane `delta` above, element by element
__device__ __forceinline__ float4 shfl_down(const float4& v, int delta) {
  return make_float4(__shfl_down_sync(0xffffffffu, v.x, delta),
                     __shfl_down_sync(0xffffffffu, v.y, delta),
                     __shfl_down_sync(0xffffffffu, v.z, delta),
                     __shfl_down_sync(0xffffffffu, v.w, delta));
}
__device__ __forceinline__ float2 shfl_down(const float2& v, int delta) {
  return make_float2(__shfl_down_sync(0xffffffffu, v.x, delta),
                     __shfl_down_sync(0xffffffffu, v.y, delta));
}

// dst += u, atomically per element (one gradient row)
__device__ __forceinline__ void atomic_add(float4* dst, const float4& u) {
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
__device__ __forceinline__ void atomic_add(float2* dst, const float2& u) {
#if GRID_VECTOR_ATOMICS
  atomicAdd(dst, u);
#else
  float* d = reinterpret_cast<float*>(dst);
  atomicAdd(d + 0, u.x);
  atomicAdd(d + 1, u.y);
#endif
}

// dst += w * v, atomically per element (row gradients of one corner)
template <typename V>
__device__ __forceinline__ void atomic_axpy(V* dst, float w, const V& v) {
  atomic_add(dst, scaled(w, v));
}

}  // namespace grid
