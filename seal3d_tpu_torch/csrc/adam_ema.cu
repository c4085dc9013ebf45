// Adam and the EMA of a training step in one launch: every leaf's moments,
// bias correction, rate, update and apply, and the exponential moving
// average of every parameter leaf, with the step's scalars formed on the
// device from the counts.
//
// Replaces no Pallas kernel: the JAX package runs optax's chain, which XLA
// fuses on the TPU. Eagerly in PyTorch (train/optim.py `Optimizer.update`,
// `apply_updates`, then the EMA) it is ~14 elementwise kernels a moved leaf
// and 3 an EMA leaf, ~13 more on 0-d tensors for the counts, corrections
// and rate, and three blocking copies of host scalars: 39 fp32 passes over
// each moved element (~156 B) where the work needs 9 (36 B).
//
// What it computes, per element of a moved leaf (p, its gradient g, the
// moments m and v, the EMA e), in the plain chain's operation order and
// rounding (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn: nothing is
// contracted into an FMA), with c the Adam count after this step's
// increment and s the schedule's count before its own:
//   m' = (1-b1)*g + b1*m            v' = (1-b2)*(g*g) + b2*v
//   bc1 = 1 - b1^c                  bc2 = 1 - b2^c          (powf)
//   rate = lr * 0.1^min(s * (1/max_steps), 1)   (lr without a schedule)
//   u = (-rate) * ((m'/bc1) / (sqrt(v'/bc2) + eps)) * scale
//   p' = p + u                      e' = e*d + p'*(1-d)
// and per element of an EMA-only leaf (a parameter the step does not move)
// e' = e*d + p*(1-d). The scalars (1-b1), (1-d), ... come from the host as
// the floats PyTorch casts the Python doubles to; 1/max_steps is the float
// reciprocal PyTorch's CUDA division by a host scalar multiplies by. The
// launch reads the counts and writes the new ones into other tensors, so no
// input is written and the host never reads a count: nothing syncs, and the
// launch replays from a CUDA graph.
//
// Layout. The host passes a table of up to kMaxLeaves leaves by value (the
// moved leaves first; a null gradient marks an EMA-only leaf): their
// pointers, lengths, per-leaf rate and scale, and each leaf's first chunk
// of kChunk elements. Block b takes chunk b: the leaf whose chunks hold it
// (a scan of the table, uniform across the block), elements
// [k*kChunk, min(n, (k+1)*kChunk)) of it. So a 12 M-element hash table and
// a 3-element bias take the same code, and the table depends only on the
// leaves' lengths.
//
// What bounds it on an H100: bytes, 36 an element of a moved leaf (p, g,
// m, v, e read; p', m', v', e' written) and 12 an EMA-only one, each
// touched once (streaming loads and stores, __ldcs / __stcs). A thread
// keeps kUnroll float4 loads of each stream in flight. Where all of a
// leaf's streams share one offset modulo 16 bytes (always, for the
// allocator's tensors) a chunk runs in float4s with at most 3 scalar
// elements at each end; where they do not (a misaligned view beside fresh
// tensors), the chunk runs in scalars.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

constexpr int kMaxLeaves = 32;         // ops/adam.py MAX_LEAVES

// The host's table of one launch (ops/adam.py `_ARGS`, the same layout).
struct AdamEMAArgs {
  const float* in[5][kMaxLeaves];      // p, g, m, v, e (g null: EMA-only)
  float* out[4][kMaxLeaves];           // p', m', v', e' (EMA-only: e' alone)
  long long n[kMaxLeaves];             // elements
  long long first_chunk[kMaxLeaves + 1];
  float lr[kMaxLeaves];                // the schedule's base rate
  float scale[kMaxLeaves];             // times the update (net_scale)
  // b1, 1-b1, b2, 1-b2, eps, d, 1-d, 1/max_steps
  float hyper[8];
  // leaves, schedule (0: constant rate), chunk size
  int flags[3];
};
static_assert(sizeof(AdamEMAArgs) == 3128, "ops/adam.py _ARGS layout");

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr long long kChunk = 4LL * kThreads * kUnroll;

struct Coef {
  float b1, omb1, b2, omb2, eps, d, omd;
  float bc1, bc2, step, scale;
};

__device__ __forceinline__ float ema(const Coef& c, float e, float p) {
  return __fadd_rn(__fmul_rn(e, c.d), __fmul_rn(p, c.omd));
}

// One element of a moved leaf: p' into p, m' into m, v' into v, e' into e.
__device__ __forceinline__ void adam(const Coef& c, float& p, float g,
                                     float& m, float& v, float& e) {
  m = __fadd_rn(__fmul_rn(c.omb1, g), __fmul_rn(c.b1, m));
  v = __fadd_rn(__fmul_rn(c.omb2, __fmul_rn(g, g)), __fmul_rn(c.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), c.eps);
  const float u = __fmul_rn(
      __fmul_rn(c.step, __fdiv_rn(__fdiv_rn(m, c.bc1), den)), c.scale);
  p = __fadd_rn(p, u);
  e = ema(c, e, p);
}

struct Leaf {
  const float *p, *g, *m, *v, *e;
  float *po, *mo, *vo, *eo;
};

__device__ __forceinline__ void scalar(const Coef& c, const Leaf& l,
                                       long long i) {
  float e = __ldcs(l.e + i);
  if (l.g) {
    float p = __ldcs(l.p + i), m = __ldcs(l.m + i), v = __ldcs(l.v + i);
    adam(c, p, __ldcs(l.g + i), m, v, e);
    __stcs(l.po + i, p);
    __stcs(l.mo + i, m);
    __stcs(l.vo + i, v);
    __stcs(l.eo + i, e);
  } else {
    __stcs(l.eo + i, ema(c, e, __ldcs(l.p + i)));
  }
}

template <typename T>
__device__ __forceinline__ const float4* f4(const T* p, long long at) {
  return reinterpret_cast<const float4*>(p + at);
}

template <typename T>
__device__ __forceinline__ float4* f4w(T* p, long long at) {
  return reinterpret_cast<float4*>(p + at);
}

__device__ __forceinline__ void adam4(const Coef& c, float4& p, float4 g,
                                      float4& m, float4& v, float4& e) {
  adam(c, p.x, g.x, m.x, v.x, e.x);
  adam(c, p.y, g.y, m.y, v.y, e.y);
  adam(c, p.z, g.z, m.z, v.z, e.z);
  adam(c, p.w, g.w, m.w, v.w, e.w);
}

__device__ __forceinline__ float4 ema4(const Coef& c, float4 e, float4 p) {
  return make_float4(ema(c, e.x, p.x), ema(c, e.y, p.y), ema(c, e.z, p.z),
                     ema(c, e.w, p.w));
}

// nv float4s from element `at` of every stream (16-byte aligned there).
__device__ __forceinline__ void vectors(const Coef& c, const Leaf& l,
                                        long long at, long long nv) {
  if (l.g) {
    float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll], e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = threadIdx.x + (long long)u * kThreads;
      if (q < nv) {
        p[u] = __ldcs(f4(l.p, at) + q);
        g[u] = __ldcs(f4(l.g, at) + q);
        m[u] = __ldcs(f4(l.m, at) + q);
        v[u] = __ldcs(f4(l.v, at) + q);
        e[u] = __ldcs(f4(l.e, at) + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = threadIdx.x + (long long)u * kThreads;
      if (q < nv) {
        adam4(c, p[u], g[u], m[u], v[u], e[u]);
        __stcs(f4w(l.po, at) + q, p[u]);
        __stcs(f4w(l.mo, at) + q, m[u]);
        __stcs(f4w(l.vo, at) + q, v[u]);
        __stcs(f4w(l.eo, at) + q, e[u]);
      }
    }
  } else {
    float4 p[kUnroll], e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = threadIdx.x + (long long)u * kThreads;
      if (q < nv) {
        p[u] = __ldcs(f4(l.p, at) + q);
        e[u] = __ldcs(f4(l.e, at) + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = threadIdx.x + (long long)u * kThreads;
      if (q < nv) __stcs(f4w(l.eo, at) + q, ema4(c, e[u], p[u]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_ema_kernel(const __grid_constant__ AdamEMAArgs a, const int* count,
                    const int* sched, int* count_out, int* sched_out) {
  const long long b = blockIdx.x;
  const int leaves = a.flags[0];
  const bool schedule = a.flags[1] != 0;
  // the counts before this step; the new ones go to other tensors
  const int c_new = *count + 1;
  const int s_old = schedule ? *sched : 0;
  if (b == 0 && threadIdx.x == 0) {
    *count_out = c_new;
    if (schedule) *sched_out = s_old + 1;
  }
  if (b >= a.first_chunk[leaves]) return;
  int k = 0;
  while (k + 1 < leaves && a.first_chunk[k + 1] <= b) ++k;

  Coef c;
  c.b1 = a.hyper[0];
  c.omb1 = a.hyper[1];
  c.b2 = a.hyper[2];
  c.omb2 = a.hyper[3];
  c.eps = a.hyper[4];
  c.d = a.hyper[5];
  c.omd = a.hyper[6];
  const float cf = (float)c_new;
  c.bc1 = __fsub_rn(1.0f, powf(c.b1, cf));
  c.bc2 = __fsub_rn(1.0f, powf(c.b2, cf));
  float rate = a.lr[k];
  if (schedule) {
    float frac = __fmul_rn((float)s_old, a.hyper[7]);
    frac = isnan(frac) ? frac : fminf(frac, 1.0f);  // clamp(max=1)
    rate = __fmul_rn(rate, powf(0.1f, frac));
  }
  c.step = -rate;
  c.scale = a.scale[k];

  const Leaf l{a.in[0][k], a.in[1][k], a.in[2][k], a.in[3][k], a.in[4][k],
               a.out[0][k], a.out[1][k], a.out[2][k], a.out[3][k]};
  const long long s = (b - a.first_chunk[k]) * kChunk;
  const long long end = min(a.n[k], s + kChunk);

  // the float4 run: all streams at one offset modulo 16 bytes
  const uintptr_t mis = reinterpret_cast<uintptr_t>(l.e) & 15;
  bool vec = (reinterpret_cast<uintptr_t>(l.p) & 15) == mis &&
             (reinterpret_cast<uintptr_t>(l.eo) & 15) == mis;
  if (l.g) {
    vec = vec && (reinterpret_cast<uintptr_t>(l.g) & 15) == mis &&
          (reinterpret_cast<uintptr_t>(l.m) & 15) == mis &&
          (reinterpret_cast<uintptr_t>(l.v) & 15) == mis &&
          (reinterpret_cast<uintptr_t>(l.po) & 15) == mis &&
          (reinterpret_cast<uintptr_t>(l.mo) & 15) == mis &&
          (reinterpret_cast<uintptr_t>(l.vo) & 15) == mis;
  }
  const long long len = end - s;
  long long head = len, nv = 0;
  if (vec) {
    head = min(len, (long long)(((16 - mis) & 15) / 4));
    nv = (len - head) / 4;
  }
  if (nv > 0) vectors(c, l, s + head, nv);
  for (long long i = s + threadIdx.x; i < s + head; i += kThreads)
    scalar(c, l, i);
  for (long long i = s + head + 4 * nv + threadIdx.x; i < end; i += kThreads)
    scalar(c, l, i);
}

}  // namespace

// One launch over the table `args` (a host pointer: the table travels as
// the kernel's parameter, so nothing is copied beforehand). count, sched:
// the Adam and schedule counts ([] int32; sched null without a schedule);
// count_out, sched_out: fresh tensors for the new counts.
extern "C" int adam_ema(const AdamEMAArgs* args, const int* count,
                        const int* sched, int* count_out, int* sched_out,
                        void* stream) {
  const int leaves = args->flags[0];
  if (leaves < 0 || leaves > kMaxLeaves || args->flags[2] != kChunk ||
      count_out == nullptr ||
      (args->flags[1] && (sched == nullptr || sched_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long chunks = args->first_chunk[leaves];
  const long long blocks = chunks > 0 ? chunks : 1;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  adam_ema_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      *args, count, sched, count_out, sched_out);
  return (int)cudaGetLastError();
}
