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
// What bounds them on an H100. The forward: bytes. Per (level, pair) it
// reads a 4-byte index and one F*4-byte row and writes F*4 bytes; index and
// value streams are contiguous and coalesced; the rows are random, from a
// table that fits the 50 MB L2 at T = 2^15 (8 MiB at F=4) and mostly does not
// at T = 2^19. The backward: the rate at which the L2 takes vector atomics
// (one per pair, one request per 32-byte sector that a warp's pairs touch:
// ~68 G/s at F=4 on uniformly random rows), more than its bytes; and where a
// level's few hundred rows take thousands of adds each, the serialisation of
// atomics on one address (PERF.md, section 6).
//
// Design. Forward: one thread per (level, pair), pairs fastest, so a warp
// reads 32 consecutive indices and writes 32 consecutive rows of the output.
// Backward: a grid of as many blocks as are resident at once, each walking
// one contiguous range of the [L, N] pairs with several pairs per thread in
// flight, one vector atomic per pair. Summing in shared memory first does
// not pay on the paths' traffic: shared float atomics are slower than the
// L2's own on rows that a few hundred pairs share (a window on every level
// made the 3-D case 1.9x slower). An index outside [0, T) reads as zeros and
// adds nothing (no out-of-bounds access).

#include <cuda_runtime.h>
#include <climits>

#include "grid_tile.cuh"
#include "grid_vec.cuh"

namespace {

using grid::atomic_add;
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

// The backward's block: threads, and pairs each thread holds in flight.
constexpr int kBwdThreads = 256;
constexpr int kBwdUnroll = 4;
constexpr int kChunk = kBwdThreads * kBwdUnroll;

// Each block walks one contiguous range of the [L, N] pairs, kChunk at a
// time, a level at a time (so the level's offset costs no division per
// pair), with one vector atomic into the L2 per valid pair.
template <int F>
__global__ void __launch_bounds__(kBwdThreads)
lookup_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  float* __restrict__ gtab, long long n_items, long long n,
                  long long t_rows, long long per_block) {
  using V = typename Vec<F>::T;
  const long long begin = (long long)blockIdx.x * per_block;
  const long long end = min(n_items, begin + per_block);
  for (long long s = begin; s < end;) {
    // the part of the range in level l: pairs [s, e)
    const long long l = s / n;
    const long long e = min(end, (l + 1) * n);
    V* level = reinterpret_cast<V*>(gtab) + l * t_rows;
    for (long long c = s + threadIdx.x; c < e; c += kChunk) {
      int k[kBwdUnroll];
      V v[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const long long i = c + (long long)u * kBwdThreads;
        k[u] = -1;
        if (i < e) {
          k[u] = __ldg(idx + i);
          v[u] = __ldg(reinterpret_cast<const V*>(g) + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (k[u] >= 0 && k[u] < t_rows) atomic_add(level + k[u], v[u]);
      }
    }
    s = e;
  }
}

// Launch the backward over a grid of resident blocks.
template <int F>
int launch_bwd(const float* g, const int* idx, float* gtab, long long n_items,
               long long n, long long t_rows, cudaStream_t st) {
  static int resident[grid::kMaxDevices] = {};
  int most = 0;
  const int err = grid::resident_blocks(lookup_bwd_kernel<F>, kBwdThreads,
                                        resident, &most);
  if (err != 0) return err;
  const long long want = (n_items + kChunk - 1) / kChunk;
  const long long blocks = want < most ? want : most;
  const long long per_block = (n_items + blocks - 1) / blocks;
  lookup_bwd_kernel<F><<<(unsigned)blocks, kBwdThreads, 0, st>>>(
      g, idx, gtab, n_items, n, t_rows, per_block);
  return (int)cudaGetLastError();
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
  return f_dim == 4 ? launch_bwd<4>(g, idx, gtab, n_items, n, t_rows, st)
                    : launch_bwd<2>(g, idx, gtab, n_items, n, t_rows, st);
}
