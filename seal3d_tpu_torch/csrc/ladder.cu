// K4: the fused ladder plan of the two-level eval march.
//
// Replaces the Pallas TPU kernel `ladder_plan` of the JAX package
// (seal3d_tpu/ops/pallas/ladder.py, kernel body `_kernel`): per ray the slab
// test against the march AABB, the n_coarse-step tightening of [near, far]
// against the 16^3 view of the occupancy bitfield, the CG group-midpoint
// tests against the dilated pooled view, and an upper bound of the fine
// sample demand from the 128^3 bitfield at each kept group's first candidate.
// The TPU kernel keeps its three tables in VMEM as f32 byte values and reads
// them through blocked one-hot bf16 MXU matmuls, because a TPU has no gather;
// its ray tiles are padded with rays that miss the box. None of that is
// carried over: the tables here are bit-packed bytes (ops/ladder.py
// `pack_tables`: 512 B, pool^3 / 8 B and the 256 KiB bitfield), read with
// plain loads, and there is no padding.
//
// What bounds it on an H100: neither bytes nor floating-point operations. A
// chunk of 32,768 rays reads 0.8 MB of rays and writes 2.5 MB of outputs
// (keep [N, CG] bytes dominate). Each ray's coarse steps and group tests are
// independent of one another; one thread per ray walks them one after the
// other, each a chain of divisions and a dependent byte load, so that design
// is bound by latency. With a warp per ray what is left is instruction
// issue: a cell coordinate costs an IEEE division and its rounding steps,
// ~15 cells a ray per lane, and each ray's slab test runs on all 32 lanes.
//
// Design: one warp per ray, so that a ray's steps run side by side. Lane i
// takes coarse steps i, i+32, ... and group tests j = i, i+32, ...; the first
// and last occupied coarse step come from __ballot_sync masks, keep is stored
// as CG consecutive bytes per ray (coalesced), and the demand is a warp sum
// of integers ceil(members) <= g, exact in any order, so it equals the
// sequential float sum. Warps walk the rays grid-stride from a grid of as
// many blocks as fit the card at once. Every product, sum and quotient that
// decides a cell index or a comparison uses an explicit round-to-nearest
// intrinsic, so nvcc contracts no FMA and substitutes no fast division: the
// kernel rounds like its plain PyTorch version (ops/ladder.py
// `ladder_plan_plain`), expression by expression, and t0, far, keep and cnt
// are bit-identical to it.

#include <cuda_runtime.h>
#include <cstdint>

#include "grid_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Spread the low 7 bits of v to every third bit.
__device__ __forceinline__ uint32_t expand7(uint32_t v) {
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

__device__ __forceinline__ uint32_t morton7(int x, int y, int z) {
  return expand7((uint32_t)x) | (expand7((uint32_t)y) << 1) |
         (expand7((uint32_t)z) << 2);
}

// Bit idx of a bit-packed table, through L1 (a copy of the coarse and pooled
// views in each block's shared memory was 1-7% slower: PERF.md, section 6).
__device__ __forceinline__ bool bit_of(const uint8_t* __restrict__ tab,
                                       uint32_t idx) {
  return (__ldg(tab + (idx >> 3)) >> (idx & 7u)) & 1u;
}

// clip((p / div * 0.5 + 0.5) * n, 0, n - 1) as an int, in that op order.
__device__ __forceinline__ int cell_of(float p, float div, float n) {
  const float c = __fmul_rn(
      __fadd_rn(__fmul_rn(__fdiv_rn(p, div), 0.5f), 0.5f), n);
  return (int)fminf(fmaxf(c, 0.0f), n - 1.0f);
}

// One axis of the slab test: (min, max) of the two plane distances. A
// direction component within 1e-15 of zero, of either sign, becomes +1e-15.
__device__ __forceinline__ void slab_axis(float o, float d, float lo, float hi,
                                          float* tlo, float* thi) {
  const float inv = __fdiv_rn(1.0f, fabsf(d) > 1e-15f ? d : 1e-15f);
  const float a = __fmul_rn(__fsub_rn(lo, o), inv);
  const float b = __fmul_rn(__fsub_rn(hi, o), inv);
  *tlo = fminf(a, b);
  *thi = fmaxf(a, b);
}

__global__ void __launch_bounds__(kThreads)
ladder_plan_kernel(const float* __restrict__ rays_o,
                   const float* __restrict__ rays_d,
                   const float* __restrict__ aabb,
                   const uint8_t* __restrict__ coarse16,
                   const uint8_t* __restrict__ pooled,
                   const uint8_t* __restrict__ fine, float* __restrict__ t0_out,
                   float* __restrict__ far_out, uint8_t* __restrict__ keep_out,
                   float* __restrict__ cnt_out, long long n, float bound,
                   float min_near, float dt_min, int cg, int g, int n_coarse,
                   int pool) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  const float lo_x = __ldg(aabb + 0), lo_y = __ldg(aabb + 1),
              lo_z = __ldg(aabb + 2), hi_x = __ldg(aabb + 3),
              hi_y = __ldg(aabb + 4), hi_z = __ldg(aabb + 5);
  const float fg = (float)g, fp = (float)pool;
  const float mid = __fmul_rn(fg - 1.0f, 0.5f);
  const float mb = fminf(1.0f, bound);

  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < n; r += stride) {
    // every lane loads the same ray (one broadcast transaction)
    const float ox = __ldg(rays_o + 3 * r), oy = __ldg(rays_o + 3 * r + 1),
                oz = __ldg(rays_o + 3 * r + 2);
    const float dx = __ldg(rays_d + 3 * r), dy = __ldg(rays_d + 3 * r + 1),
                dz = __ldg(rays_d + 3 * r + 2);

    // slab test; a miss gets near = far = 1e9
    float l0, u0, l1, u1, l2, u2;
    slab_axis(ox, dx, lo_x, hi_x, &l0, &u0);
    slab_axis(oy, dy, lo_y, hi_y, &l1, &u1);
    slab_axis(oz, dz, lo_z, hi_z, &l2, &u2);
    const float tmin = fmaxf(fmaxf(l0, l1), l2);
    const float tmax = fminf(fminf(u0, u1), u2);
    float near = fmaxf(tmin, min_near);
    float far = fmaxf(tmax, __fadd_rn(near, 1e-6f));
    if (tmax < tmin) {
      near = 1e9f;
      far = 1e9f;
    }

    // coarse tighten against the 16^3 view: lane i takes steps i, i+32, ...
    const float dt_c = __fdiv_rn(__fsub_rn(far, near), (float)n_coarse);
    int first = -1, last = -1;
    for (int base = 0; base < n_coarse; base += 32) {
      const int i = base + lane;
      bool hit = false;
      if (i < n_coarse) {
        const float tc = __fadd_rn(near, __fmul_rn((float)i + 0.5f, dt_c));
        if (tc < far) {
          const int cx =
              cell_of(__fadd_rn(ox, __fmul_rn(tc, dx)), bound, 16.0f);
          const int cy =
              cell_of(__fadd_rn(oy, __fmul_rn(tc, dy)), bound, 16.0f);
          const int cz =
              cell_of(__fadd_rn(oz, __fmul_rn(tc, dz)), bound, 16.0f);
          hit = bit_of(coarse16, morton7(cx, cy, cz));
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m != 0u) {
        if (first < 0) first = base + __ffs(m) - 1;
        last = base + 31 - __clz(m);
      }
    }
    float near2 = far, far2 = far;
    if (last >= 0) {
      near2 = fmaxf(__fadd_rn(near, __fmul_rn((float)first - 1.0f, dt_c)),
                    near);
      far2 = fminf(__fadd_rn(near, __fmul_rn((float)last + 2.0f, dt_c)), far);
    }
    if (lane == 0) {
      t0_out[r] = near2;
      far_out[r] = far2;
    }

    // group midpoints against the dilated pooled view; fine demand bound
    const float n_cand =
        fmaxf(__fdiv_rn(__fsub_rn(far2, near2), dt_min), 0.0f);
    uint8_t* keep_row = keep_out + r * cg;
    unsigned cnt = 0;
    for (int j = lane; j < cg; j += 32) {
      const float fjg = __fmul_rn((float)j, fg);
      const float tf = __fadd_rn(near2, __fmul_rn(fjg, dt_min));
      bool keep = false;
      if (tf < far2) {
        const float tm =
            __fadd_rn(near2, __fmul_rn(__fadd_rn(fjg, mid), dt_min));
        const int cx = cell_of(__fadd_rn(ox, __fmul_rn(tm, dx)), bound, fp);
        const int cy = cell_of(__fadd_rn(oy, __fmul_rn(tm, dy)), bound, fp);
        const int cz = cell_of(__fadd_rn(oz, __fmul_rn(tm, dz)), bound, fp);
        keep = bit_of(pooled, (uint32_t)((cx * pool + cy) * pool + cz));
      }
      keep_row[j] = keep ? 1 : 0;
      if (keep) {
        const int fx = cell_of(__fadd_rn(ox, __fmul_rn(tf, dx)), mb, 128.0f);
        const int fy = cell_of(__fadd_rn(oy, __fmul_rn(tf, dy)), mb, 128.0f);
        const int fz = cell_of(__fadd_rn(oz, __fmul_rn(tf, dz)), mb, 128.0f);
        if (bit_of(fine, morton7(fx, fy, fz))) {
          cnt += (unsigned)ceilf(
              fminf(fmaxf(__fsub_rn(n_cand, fjg), 0.0f), fg));
        }
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) cnt_out[r] = (float)cnt;
  }
}

}  // namespace

// rays_o, rays_d [n, 3] f32; aabb [6] f32 (device); coarse16 [512],
// pooled [pool^3 / 8] and fine [2^18] bit-packed uint8 tables; outputs t0, far,
// cnt [n] f32 and keep [n, cg] bytes (0 or 1). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int ladder_plan(const float* rays_o, const float* rays_d,
                           const float* aabb, const uint8_t* coarse16,
                           const uint8_t* pooled, const uint8_t* fine,
                           float* t0, float* far, uint8_t* keep, float* cnt,
                           long long n, float bound, float min_near,
                           float dt_min, int cg, int g, int n_coarse, int pool,
                           void* stream) {
  if (n < 0 || cg < 1 || g < 1 || n_coarse < 1 || (pool != 32 && pool != 64) ||
      !(bound > 0.0f) || !(dt_min > 0.0f) ||
      (long long)cg * g >= (1ll << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  // as many blocks as are resident at once (once per device), fewer when
  // there are fewer rays than their warps
  static int resident[grid::kMaxDevices] = {};
  int most = 0;
  const int err = grid::resident_blocks(ladder_plan_kernel, kThreads,
                                        resident, &most);
  if (err != 0) return err;
  const long long want = (n + kWarps - 1) / kWarps;
  const int blocks = (int)(want < most ? want : most);
  ladder_plan_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, aabb, coarse16, pooled, fine, t0, far, keep, cnt, n,
      bound, min_near, dt_min, cg, g, n_coarse, pool);
  return (int)cudaGetLastError();
}
