// K5: per-level row lookup on explicit indices, forward and backward.
//
// Replaces the Pallas TPU kernel pair of seal3d_tpu/ops/pallas/lookup.py:
// `multilevel_lookup` -> `_lookup_fwd_impl` (kernel body `_fwd_kernel`) and
// its backward `_lookup_bwd` (`_bwd_kernel`), which the JAX package's
// 'pallas' grid backend takes where the fused hash encode does not apply
// (align_corners, or an input dimension other than 3). The TPU kernels turn
// each lookup into blocked one-hot bf16 MXU matmuls over a [L, F, T/128, 128]
// VMEM-resident stack, and the backward into the transposed matmuls summed
// over a sequential grid, because a TPU has neither a gather nor atomics.
// Here the forward is a gather from, and the backward a vector atomicAdd
// into, the port's flat fp32 master table [L*T, F] (level l starts at row
// l*T), in fp32 throughout: the TPU kernel rounds the table (forward) and
// the cotangent (backward) to bf16, so the two differ by up to ~2e-2.
//
// What bounds them on an H100: bytes. Per (level, pair) the forward reads a
// 4-byte index and one F*4-byte row and writes F*4 bytes; the backward reads
// the index and F*4 bytes and adds F*4 bytes atomically. Index and value
// streams are contiguous and coalesced; the rows are random, from a table
// that fits the 50 MB L2 at T = 2^15 (8 MiB at F=4) and mostly does not at
// T = 2^19. The backward also serialises on hot rows (coarse levels).
//
// Design: one thread per (level, pair), pairs fastest, so a warp reads 32
// consecutive indices and writes 32 consecutive rows of the output. An index
// outside [0, T) reads as zeros and adds nothing (no out-of-bounds access).

#include <cuda_runtime.h>
#include <climits>

#include "grid_vec.cuh"

namespace {

using grid::atomic_axpy;
using grid::Vec;
using grid::zero;

constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
lookup_fwd_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  float* __restrict__ out, long long n_items, long long n,
                  long long t_rows) {
  using V = typename Vec<F>::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const long long l = i / n;
  const int k = __ldg(idx + i);
  V v;
  zero(v);
  if (k >= 0 && k < t_rows) {
    v = __ldg(reinterpret_cast<const V*>(table) + l * t_rows + k);
  }
  reinterpret_cast<V*>(out)[i] = v;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
lookup_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  float* __restrict__ gtab, long long n_items, long long n,
                  long long t_rows) {
  using V = typename Vec<F>::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const long long l = i / n;
  const int k = __ldg(idx + i);
  if (k < 0 || k >= t_rows) return;
  const V gv = __ldg(reinterpret_cast<const V*>(g) + i);
  atomic_axpy(reinterpret_cast<V*>(gtab) + l * t_rows + k, 1.0f, gv);
}

int blocks_for(int levels, long long n, long long t_rows, int f_dim,
               unsigned* blocks) {
  if (levels < 1 || n < 0 || t_rows < 1 || t_rows > INT_MAX ||
      (f_dim != 2 && f_dim != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long b = ((long long)levels * n + kThreads - 1) / kThreads;
  if (b > INT_MAX) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return 0;
}

}  // namespace

// table [levels*t_rows, f_dim] f32, idx [levels, n] int32 level-local rows,
// out [levels, n, f_dim] f32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int multilevel_lookup_fwd(const float* table, const int* idx,
                                     float* out, int levels, long long n,
                                     long long t_rows, int f_dim,
                                     void* stream) {
  unsigned blocks;
  int rc = blocks_for(levels, n, t_rows, f_dim, &blocks);
  if (rc != 0 || blocks == 0) return rc;
  const long long n_items = (long long)levels * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    lookup_fwd_kernel<4><<<blocks, kThreads, 0, st>>>(table, idx, out, n_items,
                                                      n, t_rows);
  } else {
    lookup_fwd_kernel<2><<<blocks, kThreads, 0, st>>>(table, idx, out, n_items,
                                                      n, t_rows);
  }
  return (int)cudaGetLastError();
}

// g [levels, n, f_dim] f32 output cotangent, idx as in the forward; gtab
// [levels*t_rows, f_dim] f32 must hold zeros (the caller allocates it):
// gtab[l*t_rows + idx[l, p], :] += g[l, p, :]. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int multilevel_lookup_bwd(const float* g, const int* idx,
                                     float* gtab, int levels, long long n,
                                     long long t_rows, int f_dim,
                                     void* stream) {
  unsigned blocks;
  int rc = blocks_for(levels, n, t_rows, f_dim, &blocks);
  if (rc != 0 || blocks == 0) return rc;
  const long long n_items = (long long)levels * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_dim == 4) {
    lookup_bwd_kernel<4><<<blocks, kThreads, 0, st>>>(g, idx, gtab, n_items, n,
                                                      t_rows);
  } else {
    lookup_bwd_kernel<2><<<blocks, kThreads, 0, st>>>(g, idx, gtab, n_items, n,
                                                      t_rows);
  }
  return (int)cudaGetLastError();
}
