// The reviser stack for Hopper (sm_90a): three kernels.
//
// base_rows + stack_heads replace the TPU kernel _kernel_full (nanoreviser_tpu/
// ops/reviser_kernel.py:283, core _stack_core :92, entry stack_logits_full
// :678), which does all of the following in one launch over (model, 256
// windows). Here the per-base-row work and the per-window work are two
// launches. stack_windows (at the end) replaces _kernel (:251, entries
// stack_logits_multi :611 and stack_logits_pallas :749), the same stack on
// pre-gathered per-window inputs.
//
// base_rows (grid: row blocks x 2 models). Per base row, once:
//   z1  = bf16(relu(x @ cw1 + cb1))                  50 -> 400
//   z2  = bf16(relu(z1 @ cw2 + cb2))                400 -> 400
//   s64 = bf16((z2 @ cc + x @ ce) + cbias)          400|50 -> 64
//   p1  = bf16(feats) @ wi1 + b1                      6 -> 2 x 4*16  (f32)
//   p3  = s64 @ wi3s                                 64 -> 2 x 4*128 (f32)
//   What bounds it: bytes, at the card's bf16 tensor-core peak. ~275k MACs
//   per row and model against ~4.6 KB of f32 output is ~120 FLOP/B, below
//   the H100's ~295 FLOP/B ridge (989 TFLOP/s over 3.35 TB/s). This first
//   version runs the MACs as f32 FMAs on the CUDA cores (bf16 operands are
//   exact in f32, accumulation in f32 as on the TPU's MXU), where operations
//   bound it instead (67 TFLOP/s). Cost the fusion would remove: p1
//   and p3 go through device memory, 196,619 rows x 2 models x (128 + 1024)
//   x 4 B = ~1.8 GB written and read back per full-tier batch. Fusing
//   base_rows into stack_heads is later work.
//   Design: a block takes 32 rows of one model; activations live in shared
//   memory transposed ([k][row], row stride 36 floats so float4 stores of
//   neighbouring columns hit distinct banks); each thread owns output
//   columns and keeps one accumulator per row, so every bf16 weight read
//   from L2 feeds 32 FMAs and every float4 shared read (a broadcast) 4.
//
// stack_heads (grid: blocks of 16 windows x 2 models, over the w_valid
// windows only). Per window w (rows w .. w+T-1):
//   4 Bi-LSTM layers, H = 16/64/128/64, gates i,f,c,o with Keras
//   hard_sigmoid, z = ((x_t @ wi + b) + p_t) + h @ wh in f32, c in f32, h
//   rounded to bf16 after every step; the backward pass runs t = T-1..0;
//   per t: d1 = bf16(relu(l4_t @ d1w + d1b)), d2 = bf16(relu(d1 @ d2w +
//   d2b)), m = bf16(relu(d2 @ mow + mob)), acc += m @ fw[t];
//   feature = bf16(relu(acc + fb)); logits = feature @ fow + fob;
//   probs = 1 / sum(exp(logits - max)).
//   What bounds it: operations. 5.48 M MACs per window and model
//   (executed_mac_counts(11) in the JAX package); the weights (~1 MB bf16 per
//   model) and the inputs are a few GB of L2 traffic per full batch. This
//   first version uses f32 FMAs on the CUDA cores; tensor cores (mma.sync /
//   wgmma) are later work.
//   Design: the weights cannot sit in 227 KB of shared memory, so they
//   stream through L2 (50 MB holds both models). Each block keeps the layer
//   outputs of its 16 windows for all T steps in shared memory as bf16
//   (two ping-pong buffers, [t][unit][window], 135 KB at T=11), so nothing
//   but p1/p3 reads and the logits touches device memory. A thread owns one
//   hidden unit and 1..8 windows: it computes all four gate pre-activations
//   of its unit, so the gate math and the cell state c stay in registers;
//   every weight read feeds 1..8 windows, every 16-byte shared read 8.
//
// stack_windows (grid: blocks of 16 windows x M = 1 or 2 models). Window w
// brings its own rows: feats [w][t][6] and the conv-branch output s
// [m][w][t][64], both f32, rounded to bf16 here. Per (window, t) it runs
//   layer-1 input  z1 = f_t @ wi1 + b1              6 -> 4*16 per direction
//   layer-3 signal z3s = s_t @ wi3s                64 -> 4*128 per direction
// (each in f32 from bf16 operands), then exactly stack_heads' stack core
// and heads. With no base row shared between windows nothing is hoisted:
// 6.21 M MACs per window and model at T=11, 13% more than stack_heads.
//   What bounds it: operations (f32 FMAs on the CUDA cores here; ~1.2 KB
//   of input per window against ~12 MFLOP).
//   Design: the block stages its inputs in shared memory as bf16, the
//   features in buffer A beyond layer 1's output and the conv outputs in
//   buffer B's units [128, 192), beside where layer 2 writes, so layer 3
//   reads [l2 | s] as one 192-wide input: wi3's rows, then the direction's
//   slice of wi3s (row stride 1024). No projection goes through device
//   memory. Buffers: T x (256 + 192) x 16 x 2 B = 154 KB at T=11.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kH1 = 16, kH2 = 64, kH3 = 128, kH4 = 64;
constexpr int kNB = 6;     // classes (model 2 padded to 6)
constexpr int kQ = 50;     // signal samples per row
constexpr int kQP = 64;    // gathered row width
constexpr int kConv = 400; // conv branch width (50 positions x 8 filters)

// ------------------------------------------------------------ base_rows

constexpr int kBR = 32;          // rows per block
constexpr int kLDX = kBR + 4;    // shared row stride of the transposed tiles
constexpr int kBaseThreads = 256;
constexpr int kBaseSmemFloats = (kQ + kConv + kConv + 6) * kLDX;

struct BaseWeights {  // one model; order of BASE_ORDER in ops/reviser_kernel.py
  const bf16* cw1; const float* cb1; const bf16* cw2; const float* cb2;
  const bf16* cc; const bf16* ce; const float* cbias;
  const bf16* wi1; const float* b1; const bf16* wi3s;
};
struct BasePair { BaseWeights m[2]; };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[r] = sum_k xs[k][r0 + r] * W[k][j], r < RPT (xs: shared, row stride kLDX)
template <int RPT>
__device__ __forceinline__ void dot_rows(const float* __restrict__ xs, int K,
                                         const bf16* __restrict__ W, int N,
                                         int j, int r0, float (&acc)[RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float wv = __bfloat162float(W[(size_t)k * N + j]);
    const float4* x4 = reinterpret_cast<const float4*>(xs + k * kLDX + r0);
#pragma unroll
    for (int q = 0; q < RPT / 4; ++q) {
      const float4 v = x4[q];
      acc[4 * q + 0] = fmaf(v.x, wv, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
    }
  }
}

template <int RPT>
__device__ __forceinline__ void store_col(float* __restrict__ dst, int j,
                                          int r0, const float (&v)[RPT]) {
  float4* d4 = reinterpret_cast<float4*>(dst + j * kLDX + r0);
#pragma unroll
  for (int q = 0; q < RPT / 4; ++q)
    d4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__global__ void __launch_bounds__(kBaseThreads)
base_rows_kernel(BasePair wp, const bf16* __restrict__ sig,
                 const float* __restrict__ feats, int n_rows,
                 float* __restrict__ p1, float* __restrict__ p3) {
  const int m = blockIdx.y;
  const BaseWeights& w = wp.m[m];
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kQ][kLDX]
  float* z1 = xs + kQ * kLDX;                   // [kConv][kLDX]; later s64 [64]
  float* z2 = z1 + kConv * kLDX;                // [kConv][kLDX]
  float* fs = z2 + kConv * kLDX;                // [6][kLDX]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBR;

  for (int e = tid; e < kBR * kQ; e += kBaseThreads) {
    const int r = e / kQ, k = e % kQ, row = row0 + r;
    xs[k * kLDX + r] =
        row < n_rows ? __bfloat162float(sig[(size_t)row * kQP + k]) : 0.0f;
  }
  for (int e = tid; e < kBR * 6; e += kBaseThreads) {
    const int r = e / 6, k = e % 6, row = row0 + r;
    fs[k * kLDX + r] = row < n_rows ? bf16_round(feats[(size_t)row * 6 + k]) : 0.0f;
  }
  __syncthreads();

  // z1 = bf16(relu(x @ cw1 + cb1))
  for (int j = tid; j < kConv; j += kBaseThreads) {
    float acc[kBR];
    dot_rows<kBR>(xs, kQ, w.cw1, kConv, j, 0, acc);
    const float b = w.cb1[j];
#pragma unroll
    for (int r = 0; r < kBR; ++r) acc[r] = bf16_round(fmaxf(acc[r] + b, 0.0f));
    store_col<kBR>(z1, j, 0, acc);
  }
  __syncthreads();

  // z2 = bf16(relu(z1 @ cw2 + cb2))
  for (int j = tid; j < kConv; j += kBaseThreads) {
    float acc[kBR];
    dot_rows<kBR>(z1, kConv, w.cw2, kConv, j, 0, acc);
    const float b = w.cb2[j];
#pragma unroll
    for (int r = 0; r < kBR; ++r) acc[r] = bf16_round(fmaxf(acc[r] + b, 0.0f));
    store_col<kBR>(z2, j, 0, acc);
  }
  __syncthreads();

  // s64 = bf16((z2 @ cc + x @ ce) + cbias), into z1's space:
  // 64 columns x 4 groups of 8 rows
  float* s64 = z1;
  {
    const int j = tid % 64, r0 = (tid / 64) * 8;
    float a[8], e[8];
    dot_rows<8>(z2, kConv, w.cc, 64, j, r0, a);
    dot_rows<8>(xs, kQ, w.ce, 64, j, r0, e);
    const float b = w.cbias[j];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = bf16_round((a[r] + e[r]) + b);
    store_col<8>(s64, j, r0, a);
  }
  __syncthreads();

  // p1 = f @ wi1 + b1: 128 columns x 2 groups of 16 rows
  {
    const int j = tid % 128, r0 = (tid / 128) * 16;
    float a[16];
    dot_rows<16>(fs, 6, w.wi1, 128, j, r0, a);
    const float b = w.b1[j];
    float* out = p1 + ((size_t)m * n_rows) * 128;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r0 + r;
      if (row < n_rows) out[(size_t)row * 128 + j] = a[r] + b;
    }
  }
  // p3 = s64 @ wi3s: 1024 columns in 4 passes, all 32 rows
  float* out3 = p3 + ((size_t)m * n_rows) * 1024;
  for (int j = tid; j < 1024; j += kBaseThreads) {
    float a[kBR];
    dot_rows<kBR>(s64, 64, w.wi3s, 1024, j, 0, a);
#pragma unroll
    for (int r = 0; r < kBR; ++r) {
      const int row = row0 + r;
      if (row < n_rows) out3[(size_t)row * 1024 + j] = a[r];
    }
  }
}

// ---------------------------------------------------------- stack_heads

constexpr int kG = 16;             // windows per block
constexpr int kStackThreads = 256;

struct StackWeights {  // one model; order of STACK_ORDER in ops/reviser_kernel.py
  const bf16* wh1;
  const bf16* wi2; const float* b2; const bf16* wh2;
  const bf16* wi3; const float* b3; const bf16* wh3;
  const bf16* wi4; const float* b4; const bf16* wh4;
  const bf16* d1w; const float* d1b; const bf16* d2w; const float* d2b;
  const bf16* mow; const float* mob;
  const bf16* fw; const float* fb; const bf16* fow; const float* fob;
};
struct StackPair { StackWeights m[2]; };

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.0f), 1.0f);
}

// Load RPT consecutive bf16 (window lanes r0..r0+RPT-1) from shared memory.
template <int RPT>
__device__ __forceinline__ void load_lanes(const bf16* __restrict__ src,
                                           float (&v)[RPT]) {
  if constexpr (RPT == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else if constexpr (RPT == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) v[r] = __bfloat162float(src[r]);
  }
}

// One direction of one Bi-LSTM layer over T steps for the block's kG
// windows. in: shared [T][in_ld][kG], input units [0, KIN) with weights wi
// ([KIN][wi_ld], gate g of unit j at column g*H + j) and bias b, then
// (KIN2 > 0) units [KIN, KIN + KIN2) with weights wi2 ([KIN2][wi2_ld]);
// KIN = 0: no input projection. out: shared [T][out_ld][kG], this direction
// at units [dir*H, dir*H + H). pg: optional per-row f32 pre-activation
// input (stack_heads' layer 1: p1 incl. bias; layer 3: the signal part p3),
// row (w0 + window + t), columns p_off + gate*H + unit. Per step:
// z = ((x @ wi + b) + pg_t + x2 @ wi2) + h @ wh.
template <int H, int KIN, int RPT, int KIN2 = 0>
__device__ void lstm_pass(const bf16* __restrict__ in, int in_ld,
                          bf16* __restrict__ out, int out_ld, int dir, int T,
                          const bf16* __restrict__ wi, int wi_ld,
                          const float* __restrict__ b,
                          const bf16* __restrict__ wi2, int wi2_ld,
                          const bf16* __restrict__ wh,
                          const float* __restrict__ pg, int p_ld, int p_off,
                          int w0, int n_p) {
  static_assert(H * (kG / RPT) == kStackThreads, "thread mapping");
  const int j = threadIdx.x % H;
  const int r0 = (threadIdx.x / H) * RPT;
  float c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = 0.0f;

  for (int s = 0; s < T; ++s) {
    const int t = dir ? T - 1 - s : s;
    float acc[4][RPT];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[g][r] = 0.0f;

    if constexpr (KIN > 0) {
      const bf16* x = in + (size_t)t * in_ld * kG + r0;
#pragma unroll 2
      for (int k = 0; k < KIN; ++k) {
        float xv[RPT];
        load_lanes<RPT>(x + k * kG, xv);
        const bf16* wk = wi + (size_t)k * wi_ld + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float wv = __bfloat162float(wk[g * H]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[g][r] = fmaf(xv[r], wv, acc[g][r]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float bv = b[g * H + j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[g][r] += bv;
      }
    }
    if (pg != nullptr) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        int row = w0 + r0 + r + t;
        row = row < n_p ? row : n_p - 1;
        const float* pr = pg + (size_t)row * p_ld + p_off + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][r] += pr[g * H];
      }
    }
    if constexpr (KIN2 > 0) {
      const bf16* x = in + ((size_t)t * in_ld + KIN) * kG + r0;
      float acc2[4][RPT];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc2[g][r] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < KIN2; ++k) {
        float xv[RPT];
        load_lanes<RPT>(x + k * kG, xv);
        const bf16* wk = wi2 + (size_t)k * wi2_ld + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float wv = __bfloat162float(wk[g * H]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc2[g][r] = fmaf(xv[r], wv, acc2[g][r]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[g][r] += acc2[g][r];
    }
    if (s > 0) {
      const int tp = dir ? t + 1 : t - 1;
      const bf16* hp = out + ((size_t)tp * out_ld + dir * H) * kG + r0;
      float hacc[4][RPT];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RPT; ++r) hacc[g][r] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        float hv[RPT];
        load_lanes<RPT>(hp + k * kG, hv);
        const bf16* wk = wh + (size_t)k * 4 * H + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float wv = __bfloat162float(wk[g * H]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) hacc[g][r] = fmaf(hv[r], wv, hacc[g][r]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[g][r] += hacc[g][r];
    }
    bf16* o = out + ((size_t)t * out_ld + dir * H + j) * kG + r0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float ig = hard_sigmoid(acc[0][r]);
      const float fg = hard_sigmoid(acc[1][r]);
      const float gg = tanhf(acc[2][r]);
      const float og = hard_sigmoid(acc[3][r]);
      c[r] = fg * c[r] + ig * gg;
      o[r] = __float2bfloat16_rn(og * tanhf(c[r]));
    }
    __syncthreads();
  }
}

// out[j][r] for rows r0..r0+RPT-1 = act(sum_k in[k][r] * W[k][j] + b[j]),
// in: shared bf16 [K][kG] or f32 [K][kG].
template <int RPT, typename T_IN>
__device__ __forceinline__ void head_dense(const T_IN* __restrict__ in, int K,
                                           const bf16* __restrict__ W, int N,
                                           const float* __restrict__ b, int j,
                                           int r0, float* __restrict__ out) {
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float wv = __bfloat162float(W[k * N + j]);
    float xv[RPT];
    if constexpr (sizeof(T_IN) == 2) {
      load_lanes<RPT>(reinterpret_cast<const bf16*>(in) + k * kG + r0, xv);
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r) xv[r] = in[k * kG + r0 + r];
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = fmaf(xv[r], wv, acc[r]);
  }
  const float bv = b[j];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    out[j * kG + r0 + r] = bf16_round(fmaxf(acc[r] + bv, 0.0f));
}

// The per-t relu heads, the feature, the logits and the max prob of the
// block's kG windows from layer 4's output B [T][128][kG]; A (>= 11.6 KB)
// is free and holds the f32 scratch. Writes windows w0 + r < w_valid at
// row (m * n_windows + w0 + r).
__device__ void heads_out(const StackWeights& w, bf16* A, const bf16* B,
                          int T, int m, int w0, int w_valid, int n_windows,
                          float* __restrict__ logits,
                          float* __restrict__ probs) {
  const int tid = threadIdx.x;
  float* h1 = reinterpret_cast<float*>(A);   // [128][kG]
  float* h2 = h1 + 128 * kG;                 // [32][kG]
  float* mo = h2 + 32 * kG;                  // [6][kG]
  float* fe = mo + kNB * kG;                 // [16][kG]
  const int jf = tid % 16, rf = tid / 16;    // feature unit, window
  float facc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const bf16* l4 = B + (size_t)t * 128 * kG;
    head_dense<8>(l4, 128, w.d1w, 128, w.d1b, tid % 128, (tid / 128) * 8, h1);
    __syncthreads();
    head_dense<2>(h1, 128, w.d2w, 32, w.d2b, tid % 32, (tid / 32) * 2, h2);
    __syncthreads();
    if (tid < kNB * kG)
      head_dense<1>(h2, 32, w.mow, kNB, w.mob, tid % kNB, tid / kNB, mo);
    __syncthreads();
    const bf16* fwt = w.fw + (size_t)t * kNB * 16;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      facc = fmaf(mo[c * kG + rf], __bfloat162float(fwt[c * 16 + jf]), facc);
    __syncthreads();
  }
  fe[jf * kG + rf] = bf16_round(fmaxf(facc + w.fb[jf], 0.0f));
  __syncthreads();
  if (tid < kG) {
    const int win = w0 + tid;
    if (win < w_valid) {
      float l[kNB];
      float mx = -3.0e38f;
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        float a = 0.0f;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          a = fmaf(fe[k * kG + tid], __bfloat162float(w.fow[k * kNB + c]), a);
        l[c] = a + w.fob[c];
        mx = fmaxf(mx, l[c]);
      }
      float* lo = logits + ((size_t)m * n_windows + win) * kNB;
      float den = 0.0f;
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        lo[c] = l[c];
        den += expf(l[c] - mx);
      }
      if (probs != nullptr) probs[(size_t)m * n_windows + win] = 1.0f / den;
    }
  }
}

__global__ void __launch_bounds__(kStackThreads, 1)
stack_heads_kernel(StackPair wp, const float* __restrict__ p1,
                   const float* __restrict__ p3, int n_p, int T, int w_valid,
                   int n_windows, float* __restrict__ logits,
                   float* __restrict__ probs) {
  const int m = blockIdx.y;
  const StackWeights& w = wp.m[m];
  const int w0 = blockIdx.x * kG;
  extern __shared__ uint4 smem_u4[];
  bf16* A = reinterpret_cast<bf16*>(smem_u4);   // [T][256][kG]
  bf16* B = A + (size_t)T * 256 * kG;           // [T][128][kG]
  const float* p1m = p1 + (size_t)m * n_p * 128;
  const float* p3m = p3 + (size_t)m * n_p * 1024;

  // layer 1 (H=16): z = p1_t + h @ wh1            -> A as [T][32][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH1, 0, 1>(nullptr, 0, A, 2 * kH1, d, T, nullptr, 0, nullptr,
                         nullptr, 0, w.wh1 + d * kH1 * 4 * kH1, p1m, 128,
                         d * 64, w0, n_p);
  // layer 2 (H=64): z = (l1_t @ wi2 + b2) + h @ wh2   -> B as [T][128][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH2, 2 * kH1, 4>(A, 2 * kH1, B, 2 * kH2, d, T,
                               w.wi2 + d * 2 * kH1 * 4 * kH2, 4 * kH2,
                               w.b2 + d * 4 * kH2, nullptr, 0,
                               w.wh2 + d * kH2 * 4 * kH2, nullptr, 0, 0, w0, n_p);
  // layer 3 (H=128): z = ((l2_t @ wi3 + b3) + p3_t) + h @ wh3 -> A [T][256][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH3, 2 * kH2, 8>(B, 2 * kH2, A, 2 * kH3, d, T,
                               w.wi3 + d * 2 * kH2 * 4 * kH3, 4 * kH3,
                               w.b3 + d * 4 * kH3, nullptr, 0,
                               w.wh3 + d * kH3 * 4 * kH3, p3m, 1024, d * 512,
                               w0, n_p);
  // layer 4 (H=64): z = (l3_t @ wi4 + b4) + h @ wh4   -> B as [T][128][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH4, 2 * kH3, 4>(A, 2 * kH3, B, 2 * kH4, d, T,
                               w.wi4 + d * 2 * kH3 * 4 * kH4, 4 * kH4,
                               w.b4 + d * 4 * kH4, nullptr, 0,
                               w.wh4 + d * kH4 * 4 * kH4, nullptr, 0, 0, w0, n_p);
  heads_out(w, A, B, T, m, w0, w_valid, n_windows, logits, probs);
}

// -------------------------------------------------------- stack_windows

struct PreWeights {  // one model: the per-(window, t) projections' weights
  const bf16* wi1; const float* b1; const bf16* wi3s;
};
struct WindowsArgs { PreWeights p[2]; StackWeights s[2]; };

__global__ void __launch_bounds__(kStackThreads, 1)
stack_windows_kernel(WindowsArgs wa, const float* __restrict__ feats,
                     const float* __restrict__ sig, int n_win, int T,
                     float* __restrict__ logits, float* __restrict__ probs) {
  const int m = blockIdx.y;
  const PreWeights& pw = wa.p[m];
  const StackWeights& w = wa.s[m];
  const int w0 = blockIdx.x * kG;
  const int nv = min(kG, n_win - w0);
  const int tid = threadIdx.x;
  extern __shared__ uint4 smem_u4[];
  bf16* A = reinterpret_cast<bf16*>(smem_u4);   // [T][256][kG]
  bf16* B = A + (size_t)T * 256 * kG;           // [T][192][kG]
  bf16* F = A + (size_t)T * 2 * kH1 * kG;       // [T][6][kG], after layer 1's out

  // stage the block's inputs as bf16: the features into F, the conv
  // outputs into B's units [128, 192), beside where layer 2 writes its
  // output, so that layer 3 reads [l2 | sig] as one 192-wide input.
  // Windows past n_win are zero and never written out.
  for (int e = tid; e < kG * T * 6; e += kStackThreads) {
    const int r = e / (T * 6), t = (e / 6) % T, k = e % 6;
    const float v = r < nv ? feats[((size_t)(w0 + r) * T + t) * 6 + k] : 0.0f;
    F[((size_t)t * 6 + k) * kG + r] = __float2bfloat16_rn(v);
  }
  const float* sm = sig + ((size_t)m * n_win + w0) * T * 64;
  for (int e = tid; e < kG * T * 64; e += kStackThreads) {
    const int r = e / (T * 64), t = (e / 64) % T, k = e % 64;
    const float v = r < nv ? sm[e] : 0.0f;
    B[((size_t)t * 192 + 2 * kH2 + k) * kG + r] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // layer 1 (H=16): z = (f_t @ wi1 + b1) + h @ wh1      -> A as [T][32][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH1, 6, 1>(F, 6, A, 2 * kH1, d, T, pw.wi1 + d * 4 * kH1,
                         2 * 4 * kH1, pw.b1 + d * 4 * kH1, nullptr, 0,
                         w.wh1 + d * kH1 * 4 * kH1, nullptr, 0, 0, 0, 0);
  // layer 2 (H=64): z = (l1_t @ wi2 + b2) + h @ wh2  -> B units [0,128) of 192
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH2, 2 * kH1, 4>(A, 2 * kH1, B, 192, d, T,
                               w.wi2 + d * 2 * kH1 * 4 * kH2, 4 * kH2,
                               w.b2 + d * 4 * kH2, nullptr, 0,
                               w.wh2 + d * kH2 * 4 * kH2, nullptr, 0, 0, 0, 0);
  // layer 3 (H=128): z = ((l2_t @ wi3 + b3) + s_t @ wi3s) + h @ wh3
  //                                                   -> A as [T][256][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH3, 2 * kH2, 8, 64>(B, 192, A, 2 * kH3, d, T,
                                   w.wi3 + d * 2 * kH2 * 4 * kH3, 4 * kH3,
                                   w.b3 + d * 4 * kH3, pw.wi3s + d * 4 * kH3,
                                   2 * 4 * kH3, w.wh3 + d * kH3 * 4 * kH3,
                                   nullptr, 0, 0, 0, 0);
  // layer 4 (H=64): z = (l3_t @ wi4 + b4) + h @ wh4     -> B as [T][128][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH4, 2 * kH3, 4>(A, 2 * kH3, B, 2 * kH4, d, T,
                               w.wi4 + d * 2 * kH3 * 4 * kH4, 4 * kH4,
                               w.b4 + d * 4 * kH4, nullptr, 0,
                               w.wh4 + d * kH4 * 4 * kH4, nullptr, 0, 0, 0, 0);
  heads_out(w, A, B, T, m, w0, n_win, n_win, logits, probs);
}

// Model m's stack weights from the stacked [M, ...] arrays, in STACK_ORDER.
StackWeights stack_weights_of(const void* const* w, int m, int T) {
  const size_t sizes[20] = {
      2 * kH1 * 4 * kH1,
      2 * 2 * kH1 * 4 * kH2, 2 * 4 * kH2, 2 * kH2 * 4 * kH2,
      2 * 2 * kH2 * 4 * kH3, 2 * 4 * kH3, 2 * kH3 * 4 * kH3,
      2 * 2 * kH3 * 4 * kH4, 2 * 4 * kH4, 2 * kH4 * 4 * kH4,
      128 * 128, 128, 128 * 32, 32, 32 * kNB, kNB,
      (size_t)T * kNB * 16, 16, 16 * kNB, kNB};
  const bool is_bf16[20] = {1, 1, 0, 1, 1, 0, 1, 1, 0, 1,
                            1, 0, 1, 0, 1, 0, 1, 0, 1, 0};
  const void* p[20];
  for (int i = 0; i < 20; ++i)
    p[i] = is_bf16[i] ? (const void*)((const bf16*)w[i] + m * sizes[i])
                      : (const void*)((const float*)w[i] + m * sizes[i]);
  return StackWeights{
      (const bf16*)p[0],
      (const bf16*)p[1], (const float*)p[2], (const bf16*)p[3],
      (const bf16*)p[4], (const float*)p[5], (const bf16*)p[6],
      (const bf16*)p[7], (const float*)p[8], (const bf16*)p[9],
      (const bf16*)p[10], (const float*)p[11], (const bf16*)p[12],
      (const float*)p[13], (const bf16*)p[14], (const float*)p[15],
      (const bf16*)p[16], (const float*)p[17], (const bf16*)p[18],
      (const float*)p[19]};
}

}  // namespace

extern "C" int nr_base_rows(const void* const* w, const bf16* sig,
                            const float* feats, int n_rows, float* p1,
                            float* p3, cudaStream_t stream) {
  // per-model element counts of the stacked [2, ...] weights (BASE_ORDER)
  const size_t sizes[10] = {kQ * kConv, kConv, kConv * kConv, kConv,
                            kConv * 64, kQ * 64, 64, 6 * 128, 128, 64 * 1024};
  const bool is_bf16[10] = {1, 0, 1, 0, 1, 1, 0, 1, 0, 1};
  BasePair wp;
  for (int m = 0; m < 2; ++m) {
    const void* p[10];
    for (int i = 0; i < 10; ++i)
      p[i] = is_bf16[i] ? (const void*)((const bf16*)w[i] + m * sizes[i])
                        : (const void*)((const float*)w[i] + m * sizes[i]);
    wp.m[m] = BaseWeights{(const bf16*)p[0], (const float*)p[1],
                          (const bf16*)p[2], (const float*)p[3],
                          (const bf16*)p[4], (const bf16*)p[5],
                          (const float*)p[6], (const bf16*)p[7],
                          (const float*)p[8], (const bf16*)p[9]};
  }
  const int smem = kBaseSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      base_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_rows + kBR - 1) / kBR, 2);
  base_rows_kernel<<<grid, kBaseThreads, smem, stream>>>(wp, sig, feats,
                                                          n_rows, p1, p3);
  return (int)cudaGetLastError();
}

extern "C" int nr_stack_heads(const void* const* w, const float* p1,
                              const float* p3, int n_p, int T, int w_valid,
                              int n_windows, float* logits, float* probs,
                              cudaStream_t stream) {
  StackPair wp;
  for (int m = 0; m < 2; ++m) wp.m[m] = stack_weights_of(w, m, T);
  const size_t smem = (size_t)T * (256 + 128) * kG * sizeof(bf16);
  // T >= 2 so the heads' f32 scratch (~11 KB) fits in buffer A
  if (T < 2 || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stack_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w_valid + kG - 1) / kG, 2);
  stack_heads_kernel<<<grid, kStackThreads, smem, stream>>>(
      wp, p1, p3, n_p, T, w_valid, n_windows, logits, probs);
  return (int)cudaGetLastError();
}

// w: WINDOWS_ORDER of ops/reviser_kernel.py (wi1, b1, wi3s, then
// STACK_ORDER), each stacked over n_models (1 or 2) models. feats f32
// [n_win, T, 6], sig f32 [n_models, n_win, T, 64]; logits f32
// [n_models, n_win, 6], probs f32 [n_models, n_win] or null.
extern "C" int nr_stack_windows(const void* const* w, int n_models,
                                const float* feats, const float* sig,
                                int n_win, int T, float* logits, float* probs,
                                cudaStream_t stream) {
  if (n_models < 1 || n_models > 2 || n_win < 1) return (int)cudaErrorInvalidValue;
  WindowsArgs wa = {};
  for (int m = 0; m < n_models; ++m) {
    wa.p[m] = PreWeights{(const bf16*)w[0] + (size_t)m * 6 * 8 * kH1,
                         (const float*)w[1] + (size_t)m * 8 * kH1,
                         (const bf16*)w[2] + (size_t)m * 64 * 8 * kH3};
    wa.s[m] = stack_weights_of(w + 3, m, T);
  }
  const size_t smem = (size_t)T * (256 + 192) * kG * sizeof(bf16);
  // T >= 2 so the heads' f32 scratch (~11 KB) fits in buffer A
  if (T < 2 || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stack_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_win + kG - 1) / kG, n_models);
  stack_windows_kernel<<<grid, kStackThreads, smem, stream>>>(
      wa, feats, sig, n_win, T, logits, probs);
  return (int)cudaGetLastError();
}
