// The reviser stack for Hopper (sm_90a): two kernels.
//
// stack_full replaces the TPU kernel _kernel_full (nanoreviser_tpu/ops/
// reviser_kernel.py:283, core _stack_core :92, entry stack_logits_full
// :678): one launch over (blocks of 16 windows, 2 models) runs the conv
// branch once per base row, the 4 Bi-LSTM layers, the per-t heads, the
// logits and the max prob, every product on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulation). Nothing goes back to device
// memory in between. Its design note is at its section below.
//
// stack_windows (grid: blocks of 16 windows x M = 1 or 2 models) replaces
// _kernel (:251, entries stack_logits_multi :611 and stack_logits_pallas
// :749), the same stack on pre-gathered per-window inputs. Window w brings
// its own rows: feats [w][t][6] and the conv-branch output s [m][w][t][64],
// both f32, rounded to bf16 here. Per (window, t) it runs
//   layer-1 input  z1 = f_t @ wi1 + b1              6 -> 4*16 per direction
//   layer-3 signal z3s = s_t @ wi3s                64 -> 4*128 per direction
// (each in f32 from bf16 operands), then the stack core and the heads:
//   4 Bi-LSTM layers, H = 16/64/128/64, gates i,f,c,o with Keras
//   hard_sigmoid, z = ((x_t @ wi + b) + z3s_t) + h @ wh in f32, c in f32, h
//   rounded to bf16 after every step; the backward pass runs t = T-1..0;
//   per t: d1 = bf16(relu(l4_t @ d1w + d1b)), d2 = bf16(relu(d1 @ d2w +
//   d2b)), m = bf16(relu(d2 @ mow + mob)), acc += m @ fw[t];
//   feature = bf16(relu(acc + fb)); logits = feature @ fow + fob;
//   probs = 1 / sum(exp(logits - max)).
// 6.21 M MACs per window and model at T=11.
//   What bounds it: operations (f32 FMAs on the CUDA cores here; ~1.2 KB
//   of input per window against ~12 MFLOP).
//   Design: the weights (~1 MB bf16 per model) cannot sit in 227 KB of
//   shared memory, so they stream through L2. The block stages its inputs
//   in shared memory as bf16, the features in buffer A beyond layer 1's
//   output and the conv outputs in buffer B's units [128, 192), beside
//   where layer 2 writes, so layer 3 reads [l2 | s] as one 192-wide input:
//   wi3's rows, then the direction's slice of wi3s (row stride 1024). Layer
//   outputs stay in shared memory as bf16 ([t][unit][window], two ping-pong
//   buffers): T x (256 + 192) x 16 x 2 B = 154 KB at T=11. A thread owns
//   one hidden unit and 1..8 windows: it computes all four gate
//   pre-activations of its unit, so the gate math and the cell state c
//   stay in registers; every weight read feeds 1..8 windows.

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
constexpr int kG = 16;     // windows per block
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float hard_sigmoid(float x) {
  return fminf(fmaxf(0.2f * x + 0.5f, 0.0f), 1.0f);
}

struct StackWeights {  // one model; order of STACK_ORDER in ops/reviser_kernel.py
  const bf16* wh1;
  const bf16* wi2; const float* b2; const bf16* wh2;
  const bf16* wi3; const float* b3; const bf16* wh3;
  const bf16* wi4; const float* b4; const bf16* wh4;
  const bf16* d1w; const float* d1b; const bf16* d2w; const float* d2b;
  const bf16* mow; const float* mob;
  const bf16* fw; const float* fb; const bf16* fow; const float* fob;
};

// Threads 0..kG-1: logits = fe @ fow + fob and probs = 1 / sum(exp(l -
// max)) of window w0 + tid from the bf16-rounded feature fe [16][kG] (f32),
// written at row (m * n_windows + w0 + tid) if w0 + tid < w_valid.
__device__ __forceinline__ void logits_out(const float* fe, const bf16* fow,
                                           const float* fob, int m, int w0,
                                           int w_valid, int n_windows,
                                           float* __restrict__ logits,
                                           float* __restrict__ probs) {
  const int tid = threadIdx.x;
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
          a = fmaf(fe[k * kG + tid], __bfloat162float(fow[k * kNB + c]), a);
        l[c] = a + fob[c];
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

// -------------------------------------------------------- stack_windows

constexpr int kStackThreads = 256;

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
// (KIN2 > 0) units [KIN, KIN + KIN2) with weights wi2 ([KIN2][wi2_ld]).
// out: shared [T][out_ld][kG], this direction at units [dir*H, dir*H + H).
// Per step: z = ((x @ wi + b) + x2 @ wi2) + h @ wh.
template <int H, int KIN, int RPT, int KIN2 = 0>
__device__ void lstm_pass(const bf16* __restrict__ in, int in_ld,
                          bf16* __restrict__ out, int out_ld, int dir, int T,
                          const bf16* __restrict__ wi, int wi_ld,
                          const float* __restrict__ b,
                          const bf16* __restrict__ wi2, int wi2_ld,
                          const bf16* __restrict__ wh) {
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

    {
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
  logits_out(fe, w.fow, w.fob, m, w0, w_valid, n_windows, logits, probs);
}

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
                         w.wh1 + d * kH1 * 4 * kH1);
  // layer 2 (H=64): z = (l1_t @ wi2 + b2) + h @ wh2  -> B units [0,128) of 192
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH2, 2 * kH1, 4>(A, 2 * kH1, B, 192, d, T,
                               w.wi2 + d * 2 * kH1 * 4 * kH2, 4 * kH2,
                               w.b2 + d * 4 * kH2, nullptr, 0,
                               w.wh2 + d * kH2 * 4 * kH2);
  // layer 3 (H=128): z = ((l2_t @ wi3 + b3) + s_t @ wi3s) + h @ wh3
  //                                                   -> A as [T][256][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH3, 2 * kH2, 8, 64>(B, 192, A, 2 * kH3, d, T,
                                   w.wi3 + d * 2 * kH2 * 4 * kH3, 4 * kH3,
                                   w.b3 + d * 4 * kH3, pw.wi3s + d * 4 * kH3,
                                   2 * 4 * kH3, w.wh3 + d * kH3 * 4 * kH3);
  // layer 4 (H=64): z = (l3_t @ wi4 + b4) + h @ wh4     -> B as [T][128][kG]
  for (int d = 0; d < 2; ++d)
    lstm_pass<kH4, 2 * kH3, 4>(A, 2 * kH3, B, 2 * kH4, d, T,
                               w.wi4 + d * 2 * kH3 * 4 * kH4, 4 * kH4,
                               w.b4 + d * 4 * kH4, nullptr, 0,
                               w.wh4 + d * kH4 * 4 * kH4);
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

// ----------------------------------------------------------- stack_full
//
// Grid: (blocks of kG = 16 windows over the w_valid windows) x 2 models,
// 256 threads = 8 warps. Window w covers base rows w .. w+T-1. A block:
//
// a. stages base rows w0 .. w0+31 (kG + T - 1 <= 32 are used) of the
//    gathered signal (bf16, 50 of its 64 columns) and of the features (f32,
//    rounded to bf16 here) into shared memory with cp.async; rows at or
//    past n_p = w_valid + T - 1 are zero.
// b. runs the conv branch in dense form once per staged row, as two m16
//    tiles:  z1 = bf16(relu(x @ cw1 + cb1)),  z2 = bf16(relu(z1 @ cw2 +
//    cb2)),  s64 = bf16((z2 @ cc + x @ ce) + cbias)  (the rounding of the
//    TPU kernel, :339-348). z1 and z2 live where the layer outputs go
//    later; s64 and the features stay for the whole block. The rows that
//    overlap the next block are computed again there: ~7% of the block's
//    products.
// c. runs the 4 Bi-LSTM layers, both directions at once (warps 0-3 the
//    forward pass, 4-7 the backward one), each step as one [16 windows x
//    4H] gate product   z = ((x_t @ wi + b) + s_t @ wis) + h @ wh
//    where layer 1's x_t is the features of rows w+t (k 6, zero-padded to
//    16) and layer 3's s_t the s64 rows w+t. So the layer-1 input and the
//    layer-3 signal terms are computed per (window, t) from the staged
//    rows: 13% more MACs than hoisting them per row (executed_mac_counts:
//    per_window_pregathered against per_window), but on the tensor cores,
//    and no f32 per-row projection has to sit in shared memory (26 x 1,024
//    x 4 B = 106 KB of p3 does not fit beside 140 KB of layer outputs at
//    T = 11; one direction's, 53 KB, would, but not at T = 13, which this
//    kernel also runs). mma.sync m16n8k16 with the 16 windows as M: a warp
//    owns groups of 8 hidden units and computes a group's four n8 tiles,
//    one per gate, so each thread holds i, f, c and o of the same (window,
//    unit) pairs in its accumulators and the gate math and c stay in
//    registers (wgmma would need the product transposed, 64 gate rows as M,
//    for a 16-wide N; mma.sync keeps the TPU kernel's per-step structure).
//    Layer 3 (H = 128) gives each warp 4 groups, layers 2 and 4 two, layer
//    1 one (2 warps a direction). h is rounded to bf16 and stored row-major
//    ([t][window][unit]), the A operand of the next product (ldmatrix).
// d. runs the per-t heads as three products over all 16T (t, window) rows
//    at once: d1 = bf16(relu(l4 @ d1w + d1b)), d2 = bf16(relu(d1 @ d2w +
//    d2b)), m = bf16(relu(d2 @ mow + mob)); then on the CUDA cores acc +=
//    m_t @ fw[t], feature = bf16(relu(acc + fb)), logits = feature @ fow +
//    fob, probs = 1 / sum(exp(l - max)). Windows >= w_valid are not
//    written.
//
// What bounds it: operations, 4.27e12 FLOP per full batch of 191,232
// windows by the JAX package's algorithmic count (4.3 ms at 989 TFLOP/s);
// its input and output are ~37 MB. What this design meets first is the L2:
// the LSTM weights (1 MB of fragments a model) do not fit in shared memory,
// so every step of every block streams its layer's weights from L2 again,
// 12.8 MB per block and model, 305 GB per full batch at T = 11
// (stack_full_fetch_bytes in ops/reviser_kernel.py). So the weights are packed once per engine in the
// order a warp consumes them (pack_full_weights), and each lane copies its
// own 32 bytes of every 1 KB tile into its own slice of a per-warp ring in
// shared memory with cp.async, S - 1 = 5..7 tiles ahead and across the
// step and layer barriers: no lane waits on another for weights, and 40-56
// KB a block are in flight. The conv and head weights are read once per
// block (once per pair of m-tiles for the heads) straight from L2.
//
// Packed products (pack_full_weights): the B fragments of mma.m16n8k16.
// For W [K, N], n8 tile n, k16 tile k, lane l = 4g + i:
//   [n][k][l] = (W[16k+2i][8n+g], W[16k+2i+1][8n+g], W[16k+2i+8][8n+g],
//                W[16k+2i+9][8n+g])
// and for an LSTM layer, direction d and unit group u, the k-tiles of its
// segments (wi, [wis,] wh) in turn, each as two halves of gate pairs:
//   [d][u][tile][g / 2][l][g % 2][4], gate g's n8 tile = columns
//   g*H + 8u .. +7.
//
// Shared memory: layer outputs A [T][16][264] (layers 1, 3) and B
// [T][16][136] (layers 2, 4), bf16, rows padded by 16 bytes so that the 8
// row reads of an ldmatrix phase hit distinct banks; the staged rows; the
// rings. 213,248 B at T = 11 (8-slot rings), 222,464 B at T = 13 (6-slot).

constexpr int kFullThreads = 256;
constexpr int kRows = 32;                // staged base rows per block
constexpr int kLdX = 72;                 // row strides (bf16 elements), each
constexpr int kLdF = 24;                 // an odd number of 16-byte units
constexpr int kLdZ = 408;
constexpr int kLdL1 = 40, kLdL2 = 136, kLdL3 = 264, kLdL4 = 136;
constexpr int kLdH1 = 136, kLdH2 = 40;
constexpr int kTile = 512;               // bf16 of one streamed weight tile
constexpr int kConvNT = kConv / 8;       // n8 tiles of z1 and z2

// ---- PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: a the 16x16 A fragment (row-major), b0/b1 the 16x8 B fragment
// (column-major); bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 bf16 tile in shared memory; p: this lane's
// address, row (lane & 15) and column (lane >> 4) * 8 of the tile.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- end of the PTX wrappers

__device__ __forceinline__ void put_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A warp's weights for one layer: its per-step tile sequence (contiguous in
// the packed layout), repeated T times. A tile is two halves (gates i, f,
// then c, o) of 32 lanes x 16 bytes. Each lane copies its own two 16-byte
// pieces of every tile into the same place in a slot of the warp's ring,
// S - 1 tiles ahead, and reads back only those, so the wait is per thread;
// each copy instruction of the warp moves 512 contiguous bytes, and the
// reads of 8 neighbouring lanes hit distinct banks.
template <int S>
struct WeightStream {
  const bf16* src;   // this lane's piece of the first half of tile 0
  bf16* ring;        // the same place in ring slot 0
  int per_step, total, requested, taken, next_src;

  __device__ __forceinline__ void request() {
    if (requested < total) {
      const bf16* s = src + (size_t)next_src * kTile;
      bf16* d = ring + (requested % S) * kTile;
      cp_async16(d, s);
      cp_async16(d + kTile / 2, s + kTile / 2);
      if (++next_src == per_step) next_src = 0;
    }
    cp_async_commit();   // empty past the end, so the count stays right
    ++requested;
  }

  __device__ __forceinline__ void start(const bf16* s, bf16* r, int n, int T) {
    src = s;
    ring = r;
    per_step = n;
    total = n * T;
    requested = 0;
    taken = 0;
    next_src = 0;
#pragma unroll
    for (int i = 0; i < S - 1; ++i) request();
  }

  // b[2g], b[2g + 1]: the B fragment of gate g in the next tile
  __device__ __forceinline__ void next(uint32_t (&b)[8]) {
    cp_async_wait<S - 2>();
    const bf16* p = ring + (taken % S) * kTile;
    const uint4 lo = *reinterpret_cast<const uint4*>(p);
    const uint4 hi = *reinterpret_cast<const uint4*>(p + kTile / 2);
    b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
    b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
    ++taken;
    // refills the slot read by the previous call, whose fragments the
    // caller's products have consumed
    request();
  }
};

// acc[g] += A @ (gate g's n8 tile) over K k16 tiles; a_lane: this lane's
// ldmatrix address in the first k tile. zero_a: A is zero (h before the
// first step); the tiles are taken from the stream all the same.
template <int K, int S>
__device__ __forceinline__ void gate_tiles(const bf16* a_lane, bool zero_a,
                                           WeightStream<S>& ws,
                                           float (&acc)[4][4]) {
#pragma unroll
  for (int kt = 0; kt < K; ++kt) {
    uint32_t a[4] = {0u, 0u, 0u, 0u}, b[8];
    if (!zero_a) ldsm_x4(a, a_lane + kt * 16);
    ws.next(b);
#pragma unroll
    for (int g = 0; g < 4; ++g) mma_bf16(acc[g], a, b[2 * g], b[2 * g + 1]);
  }
}

// One Bi-LSTM layer (hidden size H) over T steps, both directions at once.
// Inputs per step t, rows r = 0..15 (windows): x row (t * x_step + r) of
// x [.][x_ld] (KX k16 tiles), s row (t + r) of s [.][kLdX] (KS tiles; the
// signal rows), h of the previous step from out (KH tiles). out: [T][16]
// [out_ld], direction d at columns [d*H, d*H + H). wpack: the layer's
// packed [2][H/8][KX+KS+KH][2][32][8]; bias [2][4H].
template <int H, int KX, int KS, int KH, int S>
__device__ void lstm_layer(const bf16* x, int x_ld, int x_step, const bf16* s,
                           bf16* out, int out_ld, const bf16* wpack,
                           const float* __restrict__ bias, int T, bf16* ring) {
  constexpr int G = H / 8, GPW = G >= 4 ? G / 4 : 1, TILES = KX + KS + KH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dir = warp >> 2, u0 = (warp & 3) * GPW;
  const bool active = u0 < G;
  const int gq = lane >> 2, tq = lane & 3;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  WeightStream<S> ws;
  if (active)
    ws.start(wpack + (size_t)(dir * G + u0) * TILES * kTile + lane * 8,
             ring + lane * 8, GPW * TILES, T);
  const float* bd = bias + dir * 4 * H;
  float c[GPW][4];
#pragma unroll
  for (int q = 0; q < GPW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[q][e] = 0.0f;

  for (int st = 0; st < T; ++st) {
    const int t = dir ? T - 1 - st : st;
    if (active) {
      const int tp = st == 0 ? t : (dir ? t + 1 : t - 1);
      const bf16* xa = x + ((size_t)t * x_step + a_row) * x_ld + a_col;
      const bf16* sa = s + (size_t)(t + a_row) * kLdX + a_col;
      const bf16* ha = out + ((size_t)tp * kG + a_row) * out_ld + dir * H + a_col;
#pragma unroll
      for (int q = 0; q < GPW; ++q) {
        const int col = (u0 + q) * 8 + 2 * tq;   // this lane's first unit
        float acc[4][4], part[4][4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
        gate_tiles<KX>(xa, false, ws, acc);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bd + g * H + col));
          acc[g][0] += bv.x; acc[g][1] += bv.y;
          acc[g][2] += bv.x; acc[g][3] += bv.y;
        }
        if constexpr (KS > 0) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[g][e] = 0.0f;
          gate_tiles<KS>(sa, false, ws, part);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] += part[g][e];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[g][e] = 0.0f;
        gate_tiles<KH>(ha, st == 0, ws, part);
        // accumulator e: window gq (e < 2) or gq + 8, unit col + (e & 1)
        float hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ig = hard_sigmoid(acc[0][e] + part[0][e]);
          const float fg = hard_sigmoid(acc[1][e] + part[1][e]);
          const float gg = tanhf(acc[2][e] + part[2][e]);
          const float og = hard_sigmoid(acc[3][e] + part[3][e]);
          c[q][e] = fg * c[q][e] + ig * gg;
          hv[e] = og * tanhf(c[q][e]);
        }
        bf16* o = out + ((size_t)t * kG + gq) * out_ld + dir * H + col;
        put_bf16x2(o, hv[0], hv[1]);
        put_bf16x2(o + 8 * out_ld, hv[2], hv[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// acc[i] = rows m0 + 16i .. +15 of A (shared, bf16 [.][lda]) @ the n8 tile
// whose packed fragments start at wt ([NK][32] uint2), i < nm (1 or 2):
// each B fragment, read once from L2, feeds both m tiles.
template <int NK>
__device__ __forceinline__ void tile_mma(const bf16* A, int lda, int m0, int nm,
                                         const uint2* __restrict__ wt,
                                         float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31;
  const bf16* a0 = A + (size_t)(m0 + (lane & 15)) * lda + (lane >> 4) * 8;
#pragma unroll 5
  for (int kt = 0; kt < NK; ++kt) {
    const uint2 b = __ldg(wt + kt * 32 + lane);
    uint32_t a[4];
    ldsm_x4(a, a0 + kt * 16);
    mma_bf16(acc[0], a, b.x, b.y);
    if (nm > 1) {
      ldsm_x4(a, a0 + (size_t)16 * lda + kt * 16);
      mma_bf16(acc[1], a, b.x, b.y);
    }
  }
}

// epi(row, col, acc) for every m16n8 tile of A [16 n_mt][.] @ W (packed,
// n_nt n8 tiles of NK k16 tiles); the tasks (n tile, pair of m tiles) are
// spread over the warps. acc[0..1]: (row, col..col+1), acc[2..3]: row + 8.
template <int NK, typename Epi>
__device__ __forceinline__ void dense_tiles(const bf16* A, int lda, int n_mt,
                                            const uint2* __restrict__ W,
                                            int n_nt, const Epi& epi) {
  const int lane = threadIdx.x & 31;
  const int n_mc = (n_mt + 1) / 2;
  for (int task = threadIdx.x >> 5; task < n_nt * n_mc;
       task += kFullThreads / 32) {
    const int nt = task % n_nt, mc = task / n_nt;
    const int nm = min(2, n_mt - 2 * mc);
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    tile_mma<NK>(A, lda, 32 * mc, nm, W + (size_t)nt * NK * 32, acc);
    const int row = 32 * mc + (lane >> 2), col = nt * 8 + 2 * (lane & 3);
    epi(row, col, acc[0]);
    if (nm > 1) epi(row + 16, col, acc[1]);
  }
}

struct ReluBf16 {  // out[r][c] = bf16(relu(v + bias[c]))
  bf16* out;
  int ld;
  const float* bias;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float (&v)[4]) const {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
    put_bf16x2(out + (size_t)r * ld + c, fmaxf(v[0] + b.x, 0.0f),
               fmaxf(v[1] + b.y, 0.0f));
    put_bf16x2(out + (size_t)(r + 8) * ld + c, fmaxf(v[2] + b.x, 0.0f),
               fmaxf(v[3] + b.y, 0.0f));
  }
};

struct MainOut {  // mo[r][c] = bf16(relu(v + mob[c])) as f32, c < 6; 0 past
  float* out;
  const float* bias;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float (&v)[4]) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool on = c + j < kNB;
      const float b = on ? bias[c + j] : 0.0f;
      out[r * 8 + c + j] = on ? bf16_round(fmaxf(v[j] + b, 0.0f)) : 0.0f;
      out[(r + 8) * 8 + c + j] = on ? bf16_round(fmaxf(v[2 + j] + b, 0.0f)) : 0.0f;
    }
  }
};

struct FullWeights {  // one model, in FULL_ORDER of ops/reviser_kernel.py
  const uint2* cw1; const float* cb1; const uint2* cw2; const float* cb2;
  const uint2* cc; const uint2* ce; const float* cbias;
  const bf16* l1; const float* b1; const bf16* l2; const float* b2;
  const bf16* l3; const float* b3; const bf16* l4; const float* b4;
  const uint2* d1; const float* d1b; const uint2* d2; const float* d2b;
  const uint2* mo; const float* mob;
  const bf16* fw; const float* fb; const bf16* fow; const float* fob;
};
constexpr int kFullArgs = 25;
struct FullPair { FullWeights m[2]; };

template <int S>
__global__ void __launch_bounds__(kFullThreads, 1)
stack_full_kernel(FullPair wp, const bf16* __restrict__ sig,
                  const float* __restrict__ feats, int n_p, int T,
                  int w_valid, int n_windows, float* __restrict__ logits,
                  float* __restrict__ probs) {
  const int m = blockIdx.y;
  const FullWeights& w = wp.m[m];
  const int w0 = blockIdx.x * kG;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gq = (tid & 31) >> 2, tq = tid & 3;
  extern __shared__ uint4 smem_u4[];
  bf16* A = reinterpret_cast<bf16*>(smem_u4);              // [T][16][kLdL3]
  bf16* B = A + (size_t)T * kG * kLdL3;                     // [T][16][kLdL2]
  bf16* S64 = B + (size_t)T * kG * kLdL2;                   // [kRows][kLdX]
  bf16* FB = S64 + kRows * kLdX;                            // [kRows][kLdF]
  float* FS = reinterpret_cast<float*>(FB + kRows * kLdF);  // [kRows][6]
  bf16* ring = reinterpret_cast<bf16*>(FS + kRows * 6) + (size_t)warp * S * kTile;
  // the conv branch's scratch, in A (and B at small T) before layer 1
  bf16* X = A;                                              // [kRows][kLdX]
  bf16* Z1 = X + kRows * kLdX;                              // [kRows][kLdZ]
  bf16* Z2 = Z1 + kRows * kLdZ;                             // [kRows][kLdZ]

  // a. stage the rows
  for (int e = tid; e < kRows * 8; e += kFullThreads) {
    const int r = e >> 3, q = e & 7, row = w0 + r;
    bf16* dst = X + r * kLdX + q * 8;
    if (row < n_p) cp_async16(dst, sig + (size_t)row * kQP + q * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < kRows * 3; e += kFullThreads) {
    const int r = e / 3, q = e % 3, row = w0 + r;
    float* dst = FS + r * 6 + q * 2;
    if (row < n_p) {
      cp_async8(dst, feats + (size_t)row * 6 + q * 2);
    } else {
      dst[0] = 0.0f;
      dst[1] = 0.0f;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // signal columns 50..63 are not the model's; features to bf16, k padded
  for (int e = tid; e < kRows * (kQP - kQ); e += kFullThreads)
    X[(e / (kQP - kQ)) * kLdX + kQ + e % (kQP - kQ)] = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < kRows * 16; e += kFullThreads) {
    const int r = e >> 4, k = e & 15;
    FB[r * kLdF + k] = __float2bfloat16_rn(k < 6 ? FS[r * 6 + k] : 0.0f);
  }
  __syncthreads();

  // b. the conv branch, per row
  dense_tiles<4>(X, kLdX, 2, w.cw1, kConvNT, ReluBf16{Z1, kLdZ, w.cb1});
  __syncthreads();
  dense_tiles<25>(Z1, kLdZ, 2, w.cw2, kConvNT, ReluBf16{Z2, kLdZ, w.cb2});
  __syncthreads();
  {  // s64 = bf16((z2 @ cc + x @ ce) + cbias): n8 tile = warp
    float a[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float x[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    tile_mma<25>(Z2, kLdZ, 0, 2, w.cc + (size_t)warp * 25 * 32, a);
    tile_mma<4>(X, kLdX, 0, 2, w.ce + (size_t)warp * 4 * 32, x);
    const int col = warp * 8 + 2 * tq;
    const float2 b = __ldg(reinterpret_cast<const float2*>(w.cbias + col));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * i + gq;
      put_bf16x2(S64 + r * kLdX + col, (a[i][0] + x[i][0]) + b.x,
                 (a[i][1] + x[i][1]) + b.y);
      put_bf16x2(S64 + (r + 8) * kLdX + col, (a[i][2] + x[i][2]) + b.x,
                 (a[i][3] + x[i][3]) + b.y);
    }
  }
  __syncthreads();

  // c. the Bi-LSTM layers
  lstm_layer<kH1, 1, 0, 1, S>(FB, kLdF, 1, S64, A, kLdL1, w.l1, w.b1, T, ring);
  lstm_layer<kH2, 2, 0, 4, S>(A, kLdL1, kG, S64, B, kLdL2, w.l2, w.b2, T, ring);
  lstm_layer<kH3, 8, 4, 8, S>(B, kLdL2, kG, S64, A, kLdL3, w.l3, w.b3, T, ring);
  lstm_layer<kH4, 16, 0, 4, S>(A, kLdL3, kG, S64, B, kLdL4, w.l4, w.b4, T, ring);

  // d. the heads over the 16T (t, window) rows of layer 4's output
  const int M = kG * T;
  bf16* H1 = A;                                               // [M][kLdH1]
  bf16* H2 = H1 + (size_t)M * kLdH1;                          // [M][kLdH2]
  float* MO = reinterpret_cast<float*>(H2 + (size_t)M * kLdH2);  // [M][8]
  float* FE = MO + M * 8;                                     // [16][kG]
  dense_tiles<8>(B, kLdL4, T, w.d1, 128 / 8, ReluBf16{H1, kLdH1, w.d1b});
  __syncthreads();
  dense_tiles<8>(H1, kLdH1, T, w.d2, 32 / 8, ReluBf16{H2, kLdH2, w.d2b});
  __syncthreads();
  dense_tiles<2>(H2, kLdH2, T, w.mo, 1, MainOut{MO, w.mob});
  __syncthreads();
  const int jf = tid % 16, rf = tid / 16;    // feature unit, window
  float facc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const bf16* fwt = w.fw + (size_t)t * kNB * 16;
    const float* mr = MO + (t * kG + rf) * 8;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      facc = fmaf(mr[c], __bfloat162float(fwt[c * 16 + jf]), facc);
  }
  FE[jf * kG + rf] = bf16_round(fmaxf(facc + w.fb[jf], 0.0f));
  __syncthreads();
  logits_out(FE, w.fow, w.fob, m, w0, w_valid, n_windows, logits, probs);
}

template <int S>
int launch_full(const FullPair& wp, const bf16* sig, const float* feats,
                int n_p, int T, int w_valid, int n_windows, float* logits,
                float* probs, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stack_full_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w_valid + kG - 1) / kG, 2);
  stack_full_kernel<S><<<grid, kFullThreads, smem, stream>>>(
      wp, sig, feats, n_p, T, w_valid, n_windows, logits, probs);
  return (int)cudaGetLastError();
}

}  // namespace

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
  if (T < 2 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stack_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_win + kG - 1) / kG, n_models);
  stack_windows_kernel<<<grid, kStackThreads, smem, stream>>>(
      wa, feats, sig, n_win, T, logits, probs);
  return (int)cudaGetLastError();
}

// w: the FULL_ORDER pointers (ops/reviser_kernel.py) of model 0, then those
// of model 1. sig bf16 [>= n_p, 64] (the gather output), feats f32
// [>= n_p, 6], n_p = w_valid + T - 1; logits f32 [2, n_windows, 6] and
// probs f32 [2, n_windows] (or null) are written for windows < w_valid.
extern "C" int nr_stack_full(const void* const* w, const bf16* sig,
                             const float* feats, int n_p, int T, int w_valid,
                             int n_windows, float* logits, float* probs,
                             cudaStream_t stream) {
  // the conv scratch (56,832 B) must fit in A and B (T >= 5), the staged
  // rows must cover a block's windows (T <= 17)
  if (T < 5 || kG + T - 1 > kRows || w_valid < 1 || w_valid > n_windows ||
      n_p < w_valid + T - 1)
    return (int)cudaErrorInvalidValue;
  FullPair wp;
  for (int m = 0; m < 2; ++m) {
    const void* const* p = w + m * kFullArgs;
    wp.m[m] = FullWeights{
        (const uint2*)p[0], (const float*)p[1], (const uint2*)p[2],
        (const float*)p[3], (const uint2*)p[4], (const uint2*)p[5],
        (const float*)p[6],
        (const bf16*)p[7], (const float*)p[8], (const bf16*)p[9],
        (const float*)p[10], (const bf16*)p[11], (const float*)p[12],
        (const bf16*)p[13], (const float*)p[14],
        (const uint2*)p[15], (const float*)p[16], (const uint2*)p[17],
        (const float*)p[18], (const uint2*)p[19], (const float*)p[20],
        (const bf16*)p[21], (const float*)p[22], (const bf16*)p[23],
        (const float*)p[24]};
  }
  const size_t fixed = (size_t)T * kG * (kLdL3 + kLdL2) * sizeof(bf16) +
                       (size_t)kRows * (kLdX + kLdF) * sizeof(bf16) +
                       (size_t)kRows * 6 * sizeof(float);
  const size_t ring_slot = (size_t)(kFullThreads / 32) * kTile * sizeof(bf16);
  if (fixed + 8 * ring_slot <= kMaxSmem)
    return launch_full<8>(wp, sig, feats, n_p, T, w_valid, n_windows, logits,
                          probs, fixed + 8 * ring_slot, stream);
  if (fixed + 6 * ring_slot <= kMaxSmem)
    return launch_full<6>(wp, sig, feats, n_p, T, w_valid, n_windows, logits,
                          probs, fixed + 6 * ring_slot, stream);
  return (int)cudaErrorInvalidValue;
}
