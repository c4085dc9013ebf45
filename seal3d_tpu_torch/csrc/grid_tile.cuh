// Tile helpers shared by the grid-encode kernels (halo_encode.cu,
// hash_encode.cu). Both give a block a tile of consecutive samples, a warp
// 32 consecutive samples and one level at a time, pass the tile's features
// through shared memory, and sum, in the backward, the contributions of
// consecutive lanes that lie in one cell before the atomics.
#pragma once

#include <cuda_runtime.h>

#include "grid_vec.cuh"

namespace grid {

constexpr unsigned kFullMask = 0xffffffffu;

// Row pitch, in F-wide vectors, of a [tile][levels] feature tile in shared
// memory: odd, so the per-lane row accesses spread over the banks.
__host__ __device__ constexpr int tile_pitch(int levels) { return levels | 1; }

// Loads the positions of the tile's samples (rows s0 .. of x [m, 3]) into xs,
// coalesced, by all threads of the block; the caller places the barrier.
// Returns the tile's sample count.
__device__ __forceinline__ int load_positions(const float* __restrict__ x,
                                              long long s0, long long m,
                                              int tile, float* xs) {
  const long long left = m - s0;
  const int n = left < tile ? (int)left : tile;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
    xs[i] = __ldg(x + 3 * s0 + i);
  }
  return n;
}

// One level's scatter of a warp: tab[row[c]] += w[c] * gl over the 8 corners
// of every lane that is `ok`. A run is a stretch of consecutive lanes that
// share all 8 rows; `head` marks the lanes that start one (lane 0 always
// does, and a lane that is not ok starts its own). Each run is summed with
// shuffles, bounded by the warp's longest run, and its head makes one
// vector atomicAdd per corner; a warp without a run skips the reduction
// after one ballot. Every lane of the warp must call it.
template <typename V, typename R>
__device__ __forceinline__ void scatter_runs(V* tab, const R row[8],
                                             const float w[8], const V& gl,
                                             bool ok, bool head,
                                             unsigned lane) {
  const unsigned heads = __ballot_sync(kFullMask, head);
  if (heads == kFullMask) {
    if (ok) {
#pragma unroll
      for (int c = 0; c < 8; ++c) atomic_add(tab + row[c], scaled(w[c], gl));
    }
    return;
  }
  // my run ends before the next head above my lane
  const unsigned above = lane == 31 ? 0u : heads & (kFullMask << (lane + 1));
  const int end = above ? __ffs(above) - 1 : 32;
  const unsigned longest =
      __reduce_max_sync(kFullMask, head ? (unsigned)(end - (int)lane) : 0u);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    V u = scaled(w[c], gl);
    for (unsigned d = 1; d < longest; d <<= 1) {
      const V o = shfl_down(u, (int)d);
      if ((int)(lane + d) < end) add(u, o);
    }
    if (head && ok) atomic_add(tab + row[c], u);
  }
}

// Warps per 32-sample group (a power of two; the tile is threads / split
// samples): at most `max_split` and at most `levels`, the fewest levels any
// block walks, so no warp idles; a batch of fewer than `few_blocks` blocks
// (`groups` blocks a tile) takes more warps per group and a shorter tile, so
// that its blocks still fill the card.
inline int pick_split(long long m, int levels, int groups, int threads,
                      int max_split, long long few_blocks) {
  int split = 1;
  while (2 * split <= max_split && 2 * split <= levels) split *= 2;
  while (threads / split > 32 && 2 * split <= levels &&
         (m + threads / split - 1) / (threads / split) * groups < few_blocks) {
    split *= 2;
  }
  return split;
}

// Dynamic shared memory above 48 KB must be asked for once per kernel.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace grid
