// The NGP field head, forward and backward: from the stacked hash-grid
// encode to (sigma, rgb), and from their cotangents back to the encode's.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA, which
// fuses it on the TPU. Eagerly in PyTorch it is ~100 launches a pretraining
// batch, and at 2^19 rows it moved ~9 GB through bf16 round trips (every
// cast is a kernel that reads fp32 and writes fp32), fp32 GEMMs, ReLUs and
// their backwards, the split of the stacked encode and the colour input's
// cat. Seal-3D's own upstream ships the same idea as `ffmlp` (a fully fused
// tensor-core MLP).
//
// What it computes, per row m of enc [M, 16, 4] fp32 (level l holds the
// density grid's two features at [l, 0:2] and the colour grid's at
// [l, 2:4]) and d [M, 3]:
//   x0 = bf16(enc[m, :, 0:2])                        density input, 32
//   h1 = bf16(relu(x0 W0))      h2 = h1 W1           32 -> 64 -> 16
//   sigma = exp(h2[0])
//   xc = bf16([SH4(d) | h2[1:16] | enc[m, :, 2:4]])   colour input, 63
//   g1 = bf16(relu(xc C0))  g2 = bf16(relu(g1 C1))  g3 = g2 C2   63->64->64->3
//   rgb = sigmoid(g3)
// with every weight rounded to bf16, as models/mlp.py does. The backward
// takes the cotangents of sigma and rgb and writes the cotangent of enc,
// [M, 16, 4] fp32, in the layout the encode's backward (K2) takes.
//
// Numerics: the plain path (ops/field_head.py) rounds to bf16 at every cast
// and multiplies the rounded values in fp32. Here every product of two bf16
// values is an mma.sync m16n8k16 with fp32 accumulation (its products are
// exact), which covers every forward layer and the backward through the
// hidden layers, whose cotangents the casts have rounded to bf16. The two
// products of an fp32 cotangent and a bf16 weight (the backward of each
// output layer: K=16 for the density net, K=3 for the colour net) run in
// fp32 on the CUDA cores, as fused multiply-adds in k order. SH, exp, the
// sigmoid and their backwards follow the plain formulas' operation order
// with __fmul_rn / __fadd_rn and the accurate expf. Only fp32 summation
// order differs from the plain path, and with it, rarely, the bf16 rounding
// of a hidden activation.
//
// What bounds it on an H100: bytes. The FLOPs are trivial (~29 GFLOP
// forward plus input gradient at 2^19 rows, ~0.03 ms at the bf16 peak); the
// least traffic is enc, d and the outputs once: 149 MB forward (0.044 ms at
// 3.35 TB/s) and 283 MB backward (enc and d again, the cotangents, the
// enc cotangent out; 0.085 ms). Design:
// - All weights live in shared memory as bf16 mma B-fragments, converted
//   from the fp32 master weights by each block at its start (23.5 KB
//   forward, 46 KB backward with the transposed fragments and the two fp32
//   output layers), so there is no weight-preparation launch.
// - A warp owns 16 rows at a time and keeps every activation in registers:
//   the C-fragment of one m16n8k16 layer is, pair by pair, the A-fragment of
//   the next, so layers chain without shuffles. Lane (g, t) = (lane / 4,
//   lane % 4) loads the four float4 levels t, t+4, t+8, t+12 of rows g and
//   g+8: those are exactly its A-fragment columns of both grids, and a
//   quad reads a row's 256 bytes whole (full sectors).
// - The colour input is laid out [SH 16 | h2 16 | colour features 32]: h2
//   enters whole, straight from its C-fragments, and its column 0 (sigma's
//   pre-activation) is zeroed and gets a zero weight row, so C0's rows are
//   permuted instead of the activations shifted.
// - The backward recomputes the forward from enc rather than reading saved
//   activations (re-reading 128 MB beats writing and reading three [M, 64]
//   hidden tensors) and keeps the three ReLU masks as bits.
// - Persistent blocks of 8 warps, as many as fit the card at once, walk the
//   16-row tiles; the ragged tail is masked (rows >= M load zeros and store
//   nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowFloats = 64;        // 16 levels x (2 + 2) features
constexpr int kHidden = 64;
constexpr int kDensityIn = 32;
constexpr int kDensityOut = 16;
constexpr int kColorIn = 63;
constexpr int kColorOut = 3;

// B-fragment sets in shared memory, in fragments of 32 lanes x uint2; a set
// of a [K, N] operand holds (K / 16) x (N / 8) fragments, k-tile major.
constexpr int kOffD0 = 0;             // W0, 32 x 64
constexpr int kOffD1 = kOffD0 + 2 * 8;    // W1, 64 x 16
constexpr int kOffC0 = kOffD1 + 4 * 2;    // C0, 64 (permuted) x 64
constexpr int kOffC1 = kOffC0 + 4 * 8;    // C1, 64 x 64
constexpr int kOffC2 = kOffC1 + 4 * 8;    // C2, 64 x 8 (3 used)
constexpr int kFwdFrags = kOffC2 + 4 * 1;
constexpr int kOffC1T = kFwdFrags;        // C1^T, 64 x 64
constexpr int kOffC0T = kOffC1T + 4 * 8;  // C0^T, 64 x n-tiles 2..7
constexpr int kOffW0T = kOffC0T + 4 * 6;  // W0^T, 64 x 32
constexpr int kBwdFrags = kOffW0T + 4 * 4;

// The colour net's input row (of C0's 63) at permuted column p, or -1 for
// the zero column that carries h2's column 0 (sigma's pre-activation).
__device__ __forceinline__ int colour_row(int p) {
  return p < 16 ? p : (p == 16 ? -1 : p - 1);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element (k, n) of a B operand: W[k][n] (transposed: W[n][k]) of an
// fp32 [n_in, n_out] row-major weight, zero outside it; `colour` maps the
// input row through colour_row.
__device__ float b_elem(const float* w, int n_in, int n_out, bool transposed,
                        bool colour, int k, int n) {
  int r = transposed ? n : k;
  const int c = transposed ? k : n;
  if (colour) r = colour_row(r);
  if (r < 0 || r >= n_in || c >= n_out) return 0.f;
  return bf16r(w[r * n_out + c]);
}

// Fills `kt` x `nt` fragments (n-tiles nt0 .. nt0 + nt - 1) of one operand.
// Word i of a fragment: lane i / 2, half i % 2 (rows 2t, 2t+1 or 2t+8,
// 2t+9 of the k-tile, column g of the n-tile), so lane reads its uint2.
__device__ void load_frags(uint32_t* dst, int kt, int nt, int nt0,
                           const float* w, int n_in, int n_out,
                           bool transposed, bool colour) {
  const int words = kt * nt * 64;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int frag = i >> 6, lane = (i & 63) >> 1, half = i & 1;
    const int k = (frag / nt) * 16 + (lane & 3) * 2 + 8 * half;
    const int n = (frag % nt + nt0) * 8 + (lane >> 2);
    dst[i] = pack_bf16(b_elem(w, n_in, n_out, transposed, colour, k, n),
                       b_elem(w, n_in, n_out, transposed, colour, k + 1, n));
  }
}

__device__ void load_forward_frags(uint32_t* s, const float* w0,
                                   const float* w1, const float* c0,
                                   const float* c1, const float* c2) {
  load_frags(s + kOffD0 * 64, 2, 8, 0, w0, kDensityIn, kHidden, false, false);
  load_frags(s + kOffD1 * 64, 4, 2, 0, w1, kHidden, kDensityOut, false,
             false);
  load_frags(s + kOffC0 * 64, 4, 8, 0, c0, kColorIn, kHidden, false, true);
  load_frags(s + kOffC1 * 64, 4, 8, 0, c1, kHidden, kHidden, false, false);
  load_frags(s + kOffC2 * 64, 4, 1, 0, c2, kHidden, kColorOut, false, false);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[nt][..] += a[kt] x frags of a [16 * KT, 8 * NT] operand at `off`.
template <int KT, int NT>
__device__ __forceinline__ void layer(float (&acc)[NT][4],
                                      const uint32_t (&a)[KT][4],
                                      const uint2* frags, int off, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma(acc[nt], a[kt], frags[(off + kt * NT + nt) * 32 + lane]);
}

__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// A 16 x 64 C-fragment set -> the next layer's 4 A-fragments, ReLU'd and
// rounded to bf16; `mask` gets bit nt * 4 + i where the pre-activation
// passes ReLU's backward (threshold_backward: relu(h) > 0).
__device__ __forceinline__ void relu_pack(const float (&acc)[8][4],
                                          uint32_t (&a)[4][4],
                                          uint32_t& mask) {
  mask = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!(acc[nt][i] <= 0.f)) mask |= 1u << (nt * 4 + i);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(relu(acc[2 * j][0]), relu(acc[2 * j][1]));
    a[j][1] = pack_bf16(relu(acc[2 * j][2]), relu(acc[2 * j][3]));
    a[j][2] = pack_bf16(relu(acc[2 * j + 1][0]), relu(acc[2 * j + 1][1]));
    a[j][3] = pack_bf16(relu(acc[2 * j + 1][2]), relu(acc[2 * j + 1][3]));
  }
}

// A 16 x 64 cotangent set -> bf16 A-fragments, zero where `mask` is clear
// (the cast's backward rounds, then ReLU's backward selects).
__device__ __forceinline__ void mask_pack(const float (&acc)[8][4],
                                          uint32_t mask,
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int nt = 2 * j + h, i = 2 * r;
        a[j][2 * h + r] = pack_bf16(
            (mask >> (nt * 4 + i)) & 1 ? acc[nt][i] : 0.f,
            (mask >> (nt * 4 + i + 1)) & 1 ? acc[nt][i + 1] : 0.f);
      }
}

// Real SH of degree 4 in the plain formulas' order (ops/sh.py): each
// constant is the Python float rounded to fp32, each op rounded alone.
__device__ void sh4(float x, float y, float z, float (&s)[16]) {
  const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z),
              yz = __fmul_rn(y, z);
  const float x2 = __fmul_rn(x, x), y2 = __fmul_rn(y, y),
              z2 = __fmul_rn(z, z);
  const float c1 = static_cast<float>(0.48860251190291987);
  const float c4 = static_cast<float>(1.0925484305920792);
  const float c9 = static_cast<float>(0.59004358992664352);
  const float c11 = static_cast<float>(0.45704579946446572);
  s[0] = static_cast<float>(0.28209479177387814);
  s[1] = __fmul_rn(-c1, y);
  s[2] = __fmul_rn(c1, z);
  s[3] = __fmul_rn(-c1, x);
  s[4] = __fmul_rn(c4, xy);
  s[5] = __fmul_rn(-c4, yz);
  s[6] = __fsub_rn(__fmul_rn(static_cast<float>(0.94617469575755997), z2),
                   static_cast<float>(0.31539156525251999));
  s[7] = __fmul_rn(-c4, xz);
  s[8] = __fsub_rn(__fmul_rn(static_cast<float>(0.54627421529603959), x2),
                   __fmul_rn(static_cast<float>(0.54627421529603959), y2));
  s[9] = __fmul_rn(__fmul_rn(c9, y), __fadd_rn(__fmul_rn(-3.f, x2), y2));
  s[10] = __fmul_rn(__fmul_rn(static_cast<float>(2.8906114426405538), xy), z);
  const float one_5z2 = __fsub_rn(1.f, __fmul_rn(5.f, z2));
  s[11] = __fmul_rn(__fmul_rn(c11, y), one_5z2);
  s[12] = __fmul_rn(__fmul_rn(static_cast<float>(0.3731763325901154), z),
                    __fsub_rn(__fmul_rn(5.f, z2), 3.f));
  s[13] = __fmul_rn(__fmul_rn(c11, x), one_5z2);
  s[14] = __fmul_rn(__fmul_rn(static_cast<float>(1.4453057213202769), z),
                    __fsub_rn(x2, y2));
  s[15] = __fmul_rn(__fmul_rn(c9, x), __fadd_rn(-x2, __fmul_rn(3.f, y2)));
}

// This lane's SH pairs (columns 2t, 2t+1 and 2t+8, 2t+9) as two bf16 words.
__device__ __forceinline__ void sh_words(const float (&s)[16], int t,
                                         uint32_t& lo, uint32_t& hi) {
  switch (t) {
    case 0: lo = pack_bf16(s[0], s[1]); hi = pack_bf16(s[8], s[9]); break;
    case 1: lo = pack_bf16(s[2], s[3]); hi = pack_bf16(s[10], s[11]); break;
    case 2: lo = pack_bf16(s[4], s[5]); hi = pack_bf16(s[12], s[13]); break;
    default: lo = pack_bf16(s[6], s[7]); hi = pack_bf16(s[14], s[15]);
  }
}

__device__ __forceinline__ float sigmoid(float a) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
}

// What the backward keeps of a tile's forward.
struct Tile {
  uint32_t m_h1, m_g1, m_g2;  // ReLU masks of the three hidden layers
  float h2[2][4];             // the density net's output, columns 0-15
  float g3[4];                // the colour net's output (t = 0: 0, 1; t = 1: 2)
};

// The forward of the 16 rows at `base` for this lane: features and
// directions loaded (zeros past m), every layer through the fragments.
__device__ __forceinline__ void forward_tile(const float* __restrict__ enc,
                                             const float* __restrict__ d,
                                             long long base, long long m,
                                             const uint2* frags, int lane,
                                             Tile& out) {
  const int g = lane >> 2, t = lane & 3;
  float4 f[2][4];
  float dir[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = base + g + 8 * r;
    if (row < m) {
      const float4* p = reinterpret_cast<const float4*>(enc + row * kRowFloats);
#pragma unroll
      for (int j = 0; j < 4; ++j) f[r][j] = __ldg(p + t + 4 * j);
#pragma unroll
      for (int c = 0; c < 3; ++c) dir[r][c] = __ldg(d + row * 3 + c);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 3; ++c) dir[r][c] = 0.f;
    }
  }
  // density input: k-tile j holds levels t + 8j (columns 2t, 2t+1) and
  // t + 8j + 4 (2t+8, 2t+9); the colour features likewise at k-tiles 2, 3
  uint32_t ad[2][4], ac[4][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    ad[j][0] = pack_bf16(f[0][2 * j].x, f[0][2 * j].y);
    ad[j][1] = pack_bf16(f[1][2 * j].x, f[1][2 * j].y);
    ad[j][2] = pack_bf16(f[0][2 * j + 1].x, f[0][2 * j + 1].y);
    ad[j][3] = pack_bf16(f[1][2 * j + 1].x, f[1][2 * j + 1].y);
    ac[2 + j][0] = pack_bf16(f[0][2 * j].z, f[0][2 * j].w);
    ac[2 + j][1] = pack_bf16(f[1][2 * j].z, f[1][2 * j].w);
    ac[2 + j][2] = pack_bf16(f[0][2 * j + 1].z, f[0][2 * j + 1].w);
    ac[2 + j][3] = pack_bf16(f[1][2 * j + 1].z, f[1][2 * j + 1].w);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s[16];
    sh4(dir[r][0], dir[r][1], dir[r][2], s);
    sh_words(s, t, ac[0][r], ac[0][2 + r]);
  }

  float h1[8][4];
  uint32_t a1[4][4];
  layer<2, 8>(h1, ad, frags, kOffD0, lane);
  relu_pack(h1, a1, out.m_h1);
  layer<4, 2>(out.h2, a1, frags, kOffD1, lane);
  ac[1][0] = pack_bf16(t == 0 ? 0.f : out.h2[0][0], out.h2[0][1]);
  ac[1][1] = pack_bf16(t == 0 ? 0.f : out.h2[0][2], out.h2[0][3]);
  ac[1][2] = pack_bf16(out.h2[1][0], out.h2[1][1]);
  ac[1][3] = pack_bf16(out.h2[1][2], out.h2[1][3]);

  float hc[8][4];
  uint32_t a2[4][4];
  layer<4, 8>(hc, ac, frags, kOffC0, lane);
  relu_pack(hc, a2, out.m_g1);
  layer<4, 8>(hc, a2, frags, kOffC1, lane);
  relu_pack(hc, a2, out.m_g2);
  float g3[1][4];
  layer<4, 1>(g3, a2, frags, kOffC2, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) out.g3[i] = g3[0][i];
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 2)
field_head_fwd_kernel(const float* __restrict__ enc,
                      const float* __restrict__ d,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ c0,
                      const float* __restrict__ c1,
                      const float* __restrict__ c2,
                      float* __restrict__ sigma, float* __restrict__ rgb,
                      long long m) {
  __shared__ uint2 frags[kFwdFrags * 32];
  load_forward_frags(reinterpret_cast<uint32_t*>(frags), w0, w1, c0, c1, c2);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long tiles = (m + 15) / 16;
  for (long long tile = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += (long long)gridDim.x * kWarps) {
    Tile tl;
    forward_tile(enc, d, tile * 16, m, frags, lane, tl);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = tile * 16 + g + 8 * r;
      if (row >= m) continue;
      if (t == 0) {
        sigma[row] = expf(tl.h2[0][2 * r]);
        rgb[row * 3] = sigmoid(tl.g3[2 * r]);
        rgb[row * 3 + 1] = sigmoid(tl.g3[2 * r + 1]);
      } else if (t == 1) {
        rgb[row * 3 + 2] = sigmoid(tl.g3[2 * r]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
field_head_bwd_kernel(const float* __restrict__ enc,
                      const float* __restrict__ d,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ c0,
                      const float* __restrict__ c1,
                      const float* __restrict__ c2,
                      const float* __restrict__ g_sigma,
                      const float* __restrict__ g_rgb,
                      float* __restrict__ g_enc, long long m) {
  __shared__ uint2 frags[kBwdFrags * 32];
  __shared__ float w1t[kDensityOut * kHidden];  // bf16(W1)^T: [k][n]
  __shared__ float c2t[kColorOut * kHidden];    // bf16(C2)^T: [k][n]
  {
    uint32_t* s = reinterpret_cast<uint32_t*>(frags);
    load_forward_frags(s, w0, w1, c0, c1, c2);
    load_frags(s + kOffC1T * 64, 4, 8, 0, c1, kHidden, kHidden, true, false);
    load_frags(s + kOffC0T * 64, 4, 6, 2, c0, kColorIn, kHidden, true, true);
    load_frags(s + kOffW0T * 64, 4, 4, 0, w0, kDensityIn, kHidden, true,
               false);
    for (int i = threadIdx.x; i < kDensityOut * kHidden; i += blockDim.x)
      w1t[i] = bf16r(w1[(i % kHidden) * kDensityOut + i / kHidden]);
    for (int i = threadIdx.x; i < kColorOut * kHidden; i += blockDim.x)
      c2t[i] = bf16r(c2[(i % kHidden) * kColorOut + i / kHidden]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int quad = lane & ~3;
  const long long tiles = (m + 15) / 16;
  for (long long tile = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += (long long)gridDim.x * kWarps) {
    const long long base = tile * 16;
    Tile tl;
    forward_tile(enc, d, base, m, frags, lane, tl);

    // the sigmoid's backward: every lane takes its rows' three outputs
    // from lanes t = 0 (colours 0, 1) and t = 1 (colour 2) of its quad
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = sigmoid(tl.g3[i]);
    float dg3[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = base + g + 8 * r;
      const float yr[3] = {__shfl_sync(0xffffffffu, y[2 * r], quad),
                           __shfl_sync(0xffffffffu, y[2 * r + 1], quad),
                           __shfl_sync(0xffffffffu, y[2 * r], quad + 1)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gr = row < m ? g_rgb[row * 3 + c] : 0.f;
        dg3[r][c] = __fmul_rn(__fmul_rn(gr, __fsub_rn(1.f, yr[c])), yr[c]);
      }
    }

    // colour net: the output layer's backward in fp32 (K = 3), then the
    // hidden layers on the tensor cores
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = __fmul_rn(dg3[r][0], c2t[n]);
          v = __fmaf_rn(dg3[r][1], c2t[kHidden + n], v);
          acc[nt][2 * r + e] = __fmaf_rn(dg3[r][2], c2t[2 * kHidden + n], v);
        }
      }
    uint32_t a[4][4];
    mask_pack(acc, tl.m_g2, a);
    layer<4, 8>(acc, a, frags, kOffC1T, lane);
    mask_pack(acc, tl.m_g1, a);
    float dxc[6][4];  // the colour input's cotangent, n-tiles 2..7
    layer<4, 6>(dxc, a, frags, kOffC0T, lane);
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dxc[nt][i] = bf16r(dxc[nt][i]);

    // density net: h2's cotangent (n-tiles 0, 1 of dxc hold its columns;
    // column 0 is trunc_exp's backward), gathered whole per row, then the
    // output layer's backward in fp32 (K = 16)
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = base + g + 8 * r;
        const float gs = row < m ? g_sigma[row] : 0.f;
        const float h = fminf(fmaxf(tl.h2[0][2 * r], -15.f), 15.f);
        dxc[0][2 * r] = __fmul_rn(gs, expf(h));
      }
    }
    float dh2[2][16];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            dh2[r][8 * hh + 2 * s + e] =
                __shfl_sync(0xffffffffu, dxc[hh][2 * r + e], quad + s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = __fmul_rn(dh2[r][0], w1t[n]);
#pragma unroll
          for (int k = 1; k < kDensityOut; ++k)
            v = __fmaf_rn(dh2[r][k], w1t[k * kHidden + n], v);
          acc[nt][2 * r + e] = v;
        }
      }
    mask_pack(acc, tl.m_h1, a);
    float dx0[4][4];
    layer<4, 4>(dx0, a, frags, kOffW0T, lane);

    // level l = t + 4j of rows g, g + 8: both grids' cotangents, one float4
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = base + g + 8 * r;
      if (row >= m) continue;
      float4* out = reinterpret_cast<float4*>(g_enc + row * kRowFloats);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[t + 4 * j] = make_float4(bf16r(dx0[j][2 * r]),
                                     bf16r(dx0[j][2 * r + 1]),
                                     dxc[2 + j][2 * r], dxc[2 + j][2 * r + 1]);
    }
  }
}

namespace {

// Persistent grid: as many blocks as fit on the card at once, no more than
// the tiles need.
int grid_size(const void* kernel, long long m) {
  static int sms = 0, per_sm_fwd = 0, per_sm_bwd = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int& per_sm = kernel == (const void*)field_head_fwd_kernel ? per_sm_fwd
                                                             : per_sm_bwd;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
  const long long need = ((m + 15) / 16 + kWarps - 1) / kWarps;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(need < most ? need : most);
}

}  // namespace

extern "C" int field_head_fwd(const float* enc, const float* d,
                              const float* w0, const float* w1,
                              const float* c0, const float* c1,
                              const float* c2, float* sigma, float* rgb,
                              long long m, void* stream) {
  if (m <= 0) return 0;
  const int grid = grid_size((const void*)field_head_fwd_kernel, m);
  field_head_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      enc, d, w0, w1, c0, c1, c2, sigma, rgb, m);
  return (int)cudaGetLastError();
}

extern "C" int field_head_bwd(const float* enc, const float* d,
                              const float* w0, const float* w1,
                              const float* c0, const float* c1,
                              const float* c2, const float* g_sigma,
                              const float* g_rgb, float* g_enc, long long m,
                              void* stream) {
  if (m <= 0) return 0;
  const int grid = grid_size((const void*)field_head_bwd_kernel, m);
  field_head_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      enc, d, w0, w1, c0, c1, c2, g_sigma, g_rgb, g_enc, m);
  return (int)cudaGetLastError();
}
