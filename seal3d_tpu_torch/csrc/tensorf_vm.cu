// TensoRF VM factor lookups, forward and backward: per point, the three
// plane x line products of a VM decomposition, gathered, blended and
// multiplied in one pass, and their cotangents scattered back into the
// factors.
//
// Replaces no Pallas kernel: the JAX package writes these lookups as
// gathers and a blend (seal3d_tpu/models/tensorf.py `sample_plane`,
// `sample_line`) and leaves them to XLA. Eagerly in PyTorch the three pairs
// of one call were ~45 launches forward (corner arithmetic, four
// index_select a plane, broadcast blends over [R, N]) plus the products, the
// rank sum or the concatenation, and the backward six index_add_ scatters a
// pair: at a Seal-3D pretraining batch (2^19 points, 300^3 factors, ranks
// 16 / 48) 37 ms of device time, 24 ms of it contended scalar atomics.
//
// What it computes, with plane i spanning axes MAT_IDS[i] = (a, b) (W, H)
// and line i axis VEC_IDS[i] (models/tensorf.py), per point n of xn [N, 3]:
//   P_i[r] = bilinear(mat_i[r], xn[n, a], xn[n, b])   mat_i [R_i, H_i, W_i]
//   L_i[r] = linear(vec_i[r], xn[n, VEC_IDS[i]])      vec_i [R_i, D_i]
//   reduce:  out[n] = sum_i sum_r P_i[r] L_i[r]                  (density)
//   else:    out[n, R_0 + .. + R_{i-1} + r] = P_i[r] L_i[r]     (colour)
// zero where any coordinate lies outside [-1, 1]. The positions, corners,
// weights and blends follow the plain formula's operation order with
// __fmul_rn / __fadd_rn, so every point picks the plain path's cell and
// weights and the products are the plain path's, bit for bit; the rank sum
// differs by fp32 summation order. The backward takes the cotangent g ([N]
// or [N, sum R]) and adds g L_i w_corner into plane i's corners and
// g P_i w_corner into line i's, and, where asked, writes the coordinates'
// cotangent [N, 3] by the explicit formula (the blend's slope times the
// clip's: half at a tie, zero outside), all in fp32.
//
// Layout. The factors come in as [cells, R4] copies (R4: R rounded up to 4,
// zero-padded; the wrapper's one transpose of each factor), so a corner row
// is R4 contiguous floats: a thread owns one float4 chunk of one pair's
// ranks (an "item"), and the K = sum R4 / 4 items of a point lie on
// neighbouring lanes, which read neighbouring 16 bytes of each corner row
// and of the cotangent row (full sectors). The backward's cotangents of the
// factors accumulate into zeroed [cells, R4] scratch, which the wrapper
// transposes back.
//
// What bounds it on an H100. Forward: bytes, ~1,150 gathered floats a
// point from the factors (69.5 MB at 300^3, mostly L2-resident) and the
// output written once. Backward: the gathers again, and the rate at which
// the L2 takes atomics to a cell that neighbouring points share. Grid-
// ordered shells (z fastest) put whole runs of points in one cell of the
// xy plane and the x and y lines, and a z step of under a cell keeps the
// other planes' rows for a point or two. So a thread walks kSeg consecutive
// points of its item and keeps a running float4 sum per corner in
// registers, matched by cell (a corner that moves up one row meets the
// sum of the row below it), and sends a sum to the L2 as one 16-byte
// atomic only when its cell leaves the point's corners, or at the end of
// the walk. A zero cotangent (weight-0 padding rows, points outside) adds
// nothing and is skipped. The backward adds the components it sends into a
// device counter, one global add a block.

#include <cuda_runtime.h>
#include <climits>

#include "grid_vec.cuh"

// The host's description of one call (ops/tensorf_vm.py `_Factors`);
// outside the unnamed namespace, so the C entry points that take it keep
// external linkage.
struct VMFactors {
  const float* mat[3];  // [h*w, r4] rows of plane i's cells
  const float* vec[3];  // [d, r4]
  float* gmat[3];       // backward: zeroed scratch of the same layouts
  float* gvec[3];
  int r[3], h[3], w[3], d[3];
};

namespace {

using grid::add;
using grid::atomic_add;
using grid::zero;

// What the kernels read: the description and what follows from it.
struct Args {
  VMFactors f;
  int chunks[3];  // r4 / 4
  int row0[3];    // first feature of pair i in a [N, sum R] row
  int sum_r;
  int items;      // sum of chunks
};

constexpr int kThreads = 256;  // a block's threads at most
constexpr int kSeg = 32;       // points a backward thread walks

// The pair and rank chunk of item k.
__device__ __forceinline__ void item_of(const Args& a, int k, int& i,
                                        int& c) {
  if (k < a.chunks[0]) {
    i = 0;
    c = k;
  } else if (k < a.chunks[0] + a.chunks[1]) {
    i = 1;
    c = k - a.chunks[0];
  } else {
    i = 2;
    c = k - a.chunks[0] - a.chunks[1];
  }
}

template <typename T>
__device__ __forceinline__ T pick(int i, T v0, T v1, T v2) {
  return i == 0 ? v0 : (i == 1 ? v1 : v2);
}

// One axis of a lookup: the first corner, the weight of the second, and
// d(position in cells)/d(coordinate).
struct Axis {
  int i0;
  float f;
  float slope;
};

// `_plane_corners` / `_line_corners` along an axis of n cells, in the plain
// formula's operation order; `_coord_slope` for the slope.
__device__ __forceinline__ Axis axis_of(float c, int n, bool align) {
  float x, u, lo, hi, scale;
  if (align) {
    u = c;
    lo = -1.f;
    hi = 1.f;
    scale = 0.5f * (float)(n - 1);
    x = __fmul_rn(__fmul_rn(__fadd_rn(fminf(fmaxf(c, -1.f), 1.f), 1.f), 0.5f),
                  (float)(n - 1));
  } else {
    u = __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(c, 1.f), 0.5f), (float)n),
                  -0.5f);
    lo = 0.f;
    hi = (float)(n - 1);
    scale = 0.5f * (float)n;
    x = fminf(fmaxf(u, lo), hi);
  }
  Axis ax;
  ax.i0 = min(max((int)floorf(x), 0), n - 2);
  ax.f = __fsub_rn(x, (float)ax.i0);
  ax.slope = (u > lo && u < hi) ? scale
             : (u == lo || u == hi) ? 0.5f * scale : 0.f;
  return ax;
}

__device__ __forceinline__ float4 ld4(const float* base, long long row,
                                      int r4, int c) {
  return __ldg(reinterpret_cast<const float4*>(base + row * r4) + c);
}

// v00 (1-fx)(1-fy) + v01 fx (1-fy) + v10 (1-fx) fy + v11 fx fy, per
// component, in the plain formula's order
__device__ __forceinline__ float blend2(float v00, float v01, float v10,
                                        float v11, float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  float s = __fmul_rn(__fmul_rn(v00, gx), gy);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(v01, fx), gy));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(v10, gx), fy));
  return __fadd_rn(s, __fmul_rn(__fmul_rn(v11, fx), fy));
}

__device__ __forceinline__ float blend1(float v0, float v1, float f) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, f)), __fmul_rn(v1, f));
}

#define VM_EACH(OUT, EXPR) \
  OUT.x = EXPR(x);         \
  OUT.y = EXPR(y);         \
  OUT.z = EXPR(z);         \
  OUT.w = EXPR(w)

// One point's lookups of pair i, rank chunk c: corners, gathered rows and
// the two blends.
struct Lookup {
  Axis ax, ay, al;      // plane W, plane H, line
  int cell;             // the plane's first corner, y0 * w + x0
  float4 v00, v01, v10, v11, l0, l1;
  float4 p, l;          // the plane's and the line's blends
};

__device__ __forceinline__ void lookup(const Args& a, int i, int c,
                                       float x, float y, float z, bool align,
                                       Lookup& q) {
  const int w = pick(i, a.f.w[0], a.f.w[1], a.f.w[2]);
  const int h = pick(i, a.f.h[0], a.f.h[1], a.f.h[2]);
  const int d = pick(i, a.f.d[0], a.f.d[1], a.f.d[2]);
  const int r4 = 4 * pick(i, a.chunks[0], a.chunks[1], a.chunks[2]);
  const float* mat = pick(i, a.f.mat[0], a.f.mat[1], a.f.mat[2]);
  const float* vec = pick(i, a.f.vec[0], a.f.vec[1], a.f.vec[2]);
  // MAT_IDS = ((0, 1), (0, 2), (1, 2)), VEC_IDS = (2, 1, 0)
  q.ax = axis_of(i == 2 ? y : x, w, align);
  q.ay = axis_of(i == 0 ? y : z, h, align);
  q.al = axis_of(pick(i, z, y, x), d, align);
  q.cell = q.ay.i0 * w + q.ax.i0;
  q.v00 = ld4(mat, q.cell, r4, c);
  q.v01 = ld4(mat, q.cell + 1, r4, c);
  q.v10 = ld4(mat, q.cell + w, r4, c);
  q.v11 = ld4(mat, q.cell + w + 1, r4, c);
  q.l0 = ld4(vec, q.al.i0, r4, c);
  q.l1 = ld4(vec, q.al.i0 + 1, r4, c);
  const float fx = q.ax.f, fy = q.ay.f, fl = q.al.f;
#define VM_P(k) blend2(q.v00.k, q.v01.k, q.v10.k, q.v11.k, fx, fy)
#define VM_L(k) blend1(q.l0.k, q.l1.k, fl)
  VM_EACH(q.p, VM_P);
  VM_EACH(q.l, VM_L);
#undef VM_P
#undef VM_L
}

__device__ __forceinline__ bool inside(float x, float y, float z) {
  return fabsf(x) <= 1.f && fabsf(y) <= 1.f && fabsf(z) <= 1.f;
}

// Forward: thread (point p, item k) of a block of `points` x items threads.
template <bool kReduce>
__global__ void __launch_bounds__(kThreads)
vm_fwd_kernel(Args a, const float* __restrict__ xn, float* __restrict__ out,
              long long n, int points, bool align) {
  extern __shared__ float part[];  // kReduce: each thread's partial sum
  const int k = threadIdx.x % a.items;
  const int p = threadIdx.x / a.items;
  const long long row = (long long)blockIdx.x * points + p;
  int i, c;
  item_of(a, k, i, c);
  float4 prod;
  zero(prod);
  if (row < n) {
    const float x = __ldg(xn + 3 * row), y = __ldg(xn + 3 * row + 1),
                z = __ldg(xn + 3 * row + 2);
    if (inside(x, y, z)) {
      Lookup q;
      lookup(a, i, c, x, y, z, align, q);
#define VM_M(k) __fmul_rn(q.p.k, q.l.k)
      VM_EACH(prod, VM_M);
#undef VM_M
    }
    if (!kReduce) {
      const int r = pick(i, a.f.r[0], a.f.r[1], a.f.r[2]);
      const int valid = min(4, r - 4 * c);
      float* o = out + row * a.sum_r + pick(i, a.row0[0], a.row0[1],
                                            a.row0[2]) + 4 * c;
      o[0] = prod.x;
      if (valid > 1) o[1] = prod.y;
      if (valid > 2) o[2] = prod.z;
      if (valid > 3) o[3] = prod.w;
    }
  }
  if (kReduce) {
    // the padded ranks' products are zero: their factor columns are
    part[threadIdx.x] = __fadd_rn(__fadd_rn(__fadd_rn(prod.x, prod.y),
                                            prod.z), prod.w);
    __syncthreads();
    const long long r0 = (long long)blockIdx.x * points + threadIdx.x;
    if (threadIdx.x < points && r0 < n) {
      const float* s = part + threadIdx.x * a.items;
      float total = 0.f;
      int k0 = 0;
      for (int j = 0; j < 3; ++j) {
        float pair = 0.f;
        for (int kk = k0; kk < k0 + a.chunks[j]; ++kk) pair += s[kk];
        total += pair;
        k0 += a.chunks[j];
      }
      out[r0] = total;
    }
  }
}

// A thread's running sums of S corners: cell -1 is a free slot.
template <int S>
struct Runs {
  int cell[S];
  float4 sum[S];
};

__device__ __forceinline__ bool nonzero(const float4& v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

template <int S>
__device__ __forceinline__ void send(Runs<S>& run, int k, float4* dst,
                                     int stride, int valid,
                                     unsigned long long& sent) {
  if (run.cell[k] >= 0 && nonzero(run.sum[k])) {
    atomic_add(dst + (long long)run.cell[k] * stride, run.sum[k]);
    sent += valid;
  }
  run.cell[k] = -1;
}

// Add one point's S distinct corner cells `nc` with cotangents `u` into the
// running sums: a sum whose cell is among the new corners takes that
// corner's term; every other sum is sent; each unmatched corner opens a
// freed slot. Unrolled, so the sums stay in registers.
template <int S>
__device__ __forceinline__ void merge(Runs<S>& run, const int (&nc)[S],
                                      const float4 (&u)[S], float4* dst,
                                      int stride, int valid,
                                      unsigned long long& sent) {
  bool kept[S], hit[S];
#pragma unroll
  for (int k = 0; k < S; ++k) kept[k] = hit[k] = false;
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (run.cell[k] == nc[j]) {
        add(run.sum[k], u[j]);
        kept[k] = hit[j] = true;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (!kept[k]) send(run, k, dst, stride, valid, sent);
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    bool put = hit[j];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (!put && run.cell[k] < 0) {
        run.cell[k] = nc[j];
        run.sum[k] = u[j];
        put = true;
      }
    }
  }
}

// Backward: thread (segment s, item k) of a block of `segs` x items
// threads walks the segment's kSeg points.
template <bool kReduce, bool kDx>
__global__ void __launch_bounds__(kThreads)
vm_bwd_kernel(Args a, const float* __restrict__ xn,
              const float* __restrict__ g, float* __restrict__ dxn,
              unsigned long long* __restrict__ comps, long long n, int segs,
              bool align) {
  extern __shared__ float dx[];  // kDx: [segs * kSeg, 3]
  __shared__ unsigned long long block_sent;
  const int k = threadIdx.x % a.items;
  const int s = threadIdx.x / a.items;
  const long long first = (long long)blockIdx.x * segs * kSeg;
  if (threadIdx.x == 0) block_sent = 0;
  if (kDx) {
    for (int t = threadIdx.x; t < segs * kSeg * 3; t += blockDim.x) dx[t] = 0.f;
  }
  __syncthreads();
  int i, c;
  item_of(a, k, i, c);
  const int r = pick(i, a.f.r[0], a.f.r[1], a.f.r[2]);
  const int r4 = 4 * pick(i, a.chunks[0], a.chunks[1], a.chunks[2]);
  const int w = pick(i, a.f.w[0], a.f.w[1], a.f.w[2]);
  const int valid = min(4, r - 4 * c);
  const int feat = pick(i, a.row0[0], a.row0[1], a.row0[2]) + 4 * c;
  float4* gmat = reinterpret_cast<float4*>(
                     pick(i, a.f.gmat[0], a.f.gmat[1], a.f.gmat[2])) + c;
  float4* gvec = reinterpret_cast<float4*>(
                     pick(i, a.f.gvec[0], a.f.gvec[1], a.f.gvec[2])) + c;
  // the axes of xn that the plane's W and H and the line index
  const int axw = i == 2 ? 1 : 0, axh = i == 0 ? 1 : 2, axl = 2 - i;
  Runs<4> plane;
  Runs<2> line;
#pragma unroll
  for (int j = 0; j < 4; ++j) plane.cell[j] = -1;
#pragma unroll
  for (int j = 0; j < 2; ++j) line.cell[j] = -1;
  unsigned long long sent = 0;
  const long long begin = first + (long long)s * kSeg;
  const long long end = min(n, begin + kSeg);
  for (long long row = begin; row < end; ++row) {
    float4 gv;
    if (kReduce) {
      const float v = __ldg(g + row);
      gv = make_float4(v, v, v, v);
    } else {
      const float* gr = g + row * a.sum_r + feat;
      zero(gv);
      gv.x = __ldg(gr);
      if (valid > 1) gv.y = __ldg(gr + 1);
      if (valid > 2) gv.z = __ldg(gr + 2);
      if (valid > 3) gv.w = __ldg(gr + 3);
    }
    if (!nonzero(gv)) continue;
    const float x = __ldg(xn + 3 * row), y = __ldg(xn + 3 * row + 1),
                z = __ldg(xn + 3 * row + 2);
    if (!inside(x, y, z)) continue;
    Lookup q;
    lookup(a, i, c, x, y, z, align, q);
    const float fx = q.ax.f, fy = q.ay.f, fl = q.al.f;
    const float gx = 1.f - fx, gy = 1.f - fy, gl = 1.f - fl;
    float4 up, ul;  // the plane's and the line's cotangents
#define VM_UP(k) gv.k * q.l.k
#define VM_UL(k) gv.k * q.p.k
    VM_EACH(up, VM_UP);
    VM_EACH(ul, VM_UL);
#undef VM_UP
#undef VM_UL
    const float4 u0 = grid::scaled(gy, up), u1 = grid::scaled(fy, up);
    const int pc[4] = {q.cell, q.cell + 1, q.cell + w, q.cell + w + 1};
    const float4 pu[4] = {grid::scaled(gx, u0), grid::scaled(fx, u0),
                          grid::scaled(gx, u1), grid::scaled(fx, u1)};
    merge(plane, pc, pu, gmat, r4 / 4, valid, sent);
    const int lc[2] = {q.al.i0, q.al.i0 + 1};
    const float4 lu[2] = {grid::scaled(gl, ul), grid::scaled(fl, ul)};
    merge(line, lc, lu, gvec, r4 / 4, valid, sent);
    if (kDx) {
      float sx = 0.f, sy = 0.f, sl = 0.f;
#define VM_DX(k)                                                          \
  sx += up.k * ((q.v01.k - q.v00.k) * gy + (q.v11.k - q.v10.k) * fy);     \
  sy += up.k * ((q.v10.k - q.v00.k) * gx + (q.v11.k - q.v01.k) * fx);     \
  sl += ul.k * (q.l1.k - q.l0.k)
      VM_DX(x);
      VM_DX(y);
      VM_DX(z);
      VM_DX(w);
#undef VM_DX
      float* o = dx + (row - first) * 3;
      atomicAdd(o + axw, sx * q.ax.slope);
      atomicAdd(o + axh, sy * q.ay.slope);
      atomicAdd(o + axl, sl * q.al.slope);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) send(plane, j, gmat, r4 / 4, valid, sent);
#pragma unroll
  for (int j = 0; j < 2; ++j) send(line, j, gvec, r4 / 4, valid, sent);
  // (a block's last warp may be partial: no full-warp shuffle)
  if (sent) atomicAdd(&block_sent, sent);
  __syncthreads();
  if (threadIdx.x == 0 && block_sent) atomicAdd(comps, block_sent);
  if (kDx) {
    for (int t = threadIdx.x; t < segs * kSeg * 3; t += blockDim.x) {
      if (first * 3 + t < n * 3) dxn[first * 3 + t] = dx[t];
    }
  }
}

#undef VM_EACH

// The kernels' Args from the host's description; 0 or cudaErrorInvalidValue.
int args_of(const VMFactors* f, long long n, Args* a) {
  if (f == nullptr || n < 0) return (int)cudaErrorInvalidValue;
  a->f = *f;
  a->items = 0;
  a->sum_r = 0;
  for (int i = 0; i < 3; ++i) {
    const int r = f->r[i];
    if (r < 1 || f->h[i] < 2 || f->w[i] < 2 || f->d[i] < 2 ||
        (long long)f->h[i] * f->w[i] * (r + 3) >= INT_MAX ||
        (long long)f->d[i] * (r + 3) >= INT_MAX) {
      return (int)cudaErrorInvalidValue;
    }
    a->chunks[i] = (r + 3) / 4;
    a->row0[i] = a->sum_r;
    a->sum_r += r;
    a->items += a->chunks[i];
  }
  if (a->items > kThreads) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Forward. f: the three pairs ([cells, r4] copies; gmat, gvec unused), xn
// [n, 3] f32; out [n] (reduce) or [n, sum r] f32. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int tensorf_vm_fwd(const VMFactors* f, const float* xn, float* out,
                              long long n, int reduce, int align_corners,
                              void* stream) {
  Args a;
  int rc = args_of(f, n, &a);
  if (rc != 0 || n == 0) return rc;
  const int points = kThreads / a.items;
  const long long blocks = (n + points - 1) / points;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int threads = points * a.items;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reduce) {
    vm_fwd_kernel<true><<<(unsigned)blocks, threads, threads * sizeof(float),
                          st>>>(a, xn, out, n, points, align_corners != 0);
  } else {
    vm_fwd_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        a, xn, out, n, points, align_corners != 0);
  }
  return (int)cudaGetLastError();
}

// Backward. f: as in the forward, with gmat, gvec zeroed [cells, r4] f32
// scratch that the cotangents of the factors are added into; g [n] (reduce)
// or [n, sum r] f32; dxn [n, 3] f32 written where not null; comps: an int64
// device counter that gains the components sent by atomics. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int tensorf_vm_bwd(const VMFactors* f, const float* xn,
                              const float* g, float* dxn,
                              unsigned long long* comps, long long n,
                              int reduce, int align_corners, void* stream) {
  Args a;
  int rc = args_of(f, n, &a);
  if (rc != 0 || n == 0) return rc;
  const int segs = kThreads / a.items;
  const long long per_block = (long long)segs * kSeg;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int threads = segs * a.items;
  const size_t smem = dxn ? per_block * 3 * sizeof(float) : 0;
  const bool al = align_corners != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned b = (unsigned)blocks;
  if (reduce) {
    if (dxn) {
      vm_bwd_kernel<true, true><<<b, threads, smem, st>>>(a, xn, g, dxn, comps,
                                                         n, segs, al);
    } else {
      vm_bwd_kernel<true, false><<<b, threads, 0, st>>>(a, xn, g, dxn, comps,
                                                        n, segs, al);
    }
  } else if (dxn) {
    vm_bwd_kernel<false, true><<<b, threads, smem, st>>>(a, xn, g, dxn, comps,
                                                        n, segs, al);
  } else {
    vm_bwd_kernel<false, false><<<b, threads, 0, st>>>(a, xn, g, dxn, comps,
                                                       n, segs, al);
  }
  return (int)cudaGetLastError();
}
