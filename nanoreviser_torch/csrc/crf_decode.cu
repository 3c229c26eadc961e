// CRF decode of Bonito's CTC-CRF scores for Hopper (sm_90a): forward-
// backward posteriors, Viterbi over their logs, traceback.
//
// No TPU kernel corresponds: the JAX package has no basecaller. The plain
// version is ops/crf_decode.py crf_decode_plain; the arithmetic below
// follows it step for step (same normalisations, same tie rules).
//
// Scores: [T, N, S * 4] fp16, column s * 4 + r the move into state s that
// emits base r; the stay in s (column 0 of Bonito's groups of 5) has the
// constant score `blank`. S = 4^state_len states; the move into s comes
// from prev(s, r) = s / 4 + r * S / 4. With all start and end states free:
//
//   backward: B_T = 0;  B_{t-1}[p] = lse(blank + B_t[p],
//                         M_t[s_q, r_p] + B_t[s_q] for q < 4),
//             s_q = 4 (p mod S/4) + q, r_p = p / (S/4); B_{t-1} -= max B_{t-1}
//   forward:  A_0 = V_0 = 0; per step t, per state s and column j
//             (j = 0 the stay, j = 1 + r the move from prev(s, r)):
//             u = A_{t-1}[from] + M_t[s, j] + B_t[s];  L = lse over all (s, j)
//             lp = log(exp(u - L) + 1e-8)              (the log posterior)
//             V_t[s] = max_j (V_{t-1}[from] - max V_{t-1} + lp), first max;
//             A_t[s] = lse_j(A_{t-1}[from] + M_t[s, j]) - max over s
//   end:      the first state of largest V_T, then back along the choices;
//             label = j (0 emits nothing), quality of an emitted move
//             33 + clamp(rint(-10 log10(1 - p)), 1, 50), p its posterior.
//
// What bounds it on this card: latency. A chunk is 2T dependent steps of a
// few dozen operations per state, each ending in a block-wide reduction,
// and a traceback of T dependent loads. One block per chunk, one thread
// per state (S = 256: 8 blocks an SM), so the SM hides one block's
// barriers and loads behind the others'. The backward pass keeps B in
// shared memory and writes each step's B to global (f32 [N, T + 1, S]);
// the forward pass keeps A and V in shared memory, reads B_t back and
// writes a choice (and a quality byte) per step and state (u8 [N, T, S]).
// The reductions are warp butterflies, which leave every lane with the
// same sum (the combine below is commutative in floating point), then the
// warps' partials combined in one order by every thread.
//
// Exactness: compiled without --use_fast_math (expf, logf, log1pf are the
// accurate ones), as every source of this package.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -INFINITY;
constexpr float kQScale = -4.3429448190325175f;   // -10 / ln(10)

// (m, s) stands for s * exp(m); combine two such sums
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else if (m2 > kNegInf) {
    s = s + s2 * expf(m2 - m);
  }
}

__device__ __forceinline__ float lse5(const float x[5]) {
  float m = x[0];
#pragma unroll
  for (int j = 1; j < 5; ++j) m = fmaxf(m, x[j]);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 5; ++j) s += expf(x[j] - m);
  return m + logf(s);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void crf_decode_kernel(const __half* __restrict__ scores, int T, int N,
                                  int state_len, float blank,
                                  float* __restrict__ betas,
                                  uint8_t* __restrict__ bp,
                                  uint8_t* __restrict__ qs,
                                  uint8_t* __restrict__ labels,
                                  uint8_t* __restrict__ quals) {
  extern __shared__ float sm[];
  __shared__ float red[32][4];
  __shared__ int best_s;

  const int S = 1 << (2 * state_len);
  const int hi = S >> 2;
  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5, n_warps = blockDim.x >> 5;
  const bool active = s < S;
  const size_t row_stride = (size_t)N * 4 * S;            // one step of scores
  const __half* base = scores + (size_t)n * 4 * S;
  float* beta = betas + (size_t)n * (T + 1) * S;
  uint8_t* bpn = bp + (size_t)n * T * S;
  uint8_t* qsn = qs ? qs + (size_t)n * T * S : nullptr;

  // ---- backward: B in sm[0, 2S)
  float* B = sm;
  if (active) {
    B[(T & 1) * S + s] = 0.f;
    beta[(size_t)T * S + s] = 0.f;
  }
  __syncthreads();
  const int r_p = s / (hi > 0 ? hi : 1);
  const int succ0 = 4 * (hi > 0 ? s % hi : 0);
  for (int t = T; t >= 1; --t) {
    const float* Bt = B + (t & 1) * S;
    float bn = kNegInf;
    if (active) {
      const __half* row = base + (size_t)(t - 1) * row_stride;
      float x[5];
      x[0] = blank + Bt[s];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sq = succ0 + q;
        x[1 + q] = __half2float(row[sq * 4 + r_p]) + Bt[sq];
      }
      bn = lse5(x);
    }
    float mx = warp_max(bn);
    if (lane == 0) red[warp][0] = mx;
    __syncthreads();
    mx = red[0][0];
    for (int w = 1; w < n_warps; ++w) mx = fmaxf(mx, red[w][0]);
    if (active) {
      const float bh = bn - mx;
      B[((t - 1) & 1) * S + s] = bh;
      beta[(size_t)(t - 1) * S + s] = bh;
    }
    __syncthreads();
  }

  // ---- forward with posteriors and Viterbi: A in sm[0, 2S), V in sm[2S, 4S)
  float* A = sm;
  float* V = sm + 2 * S;
  if (active) {
    A[s] = 0.f;
    V[s] = 0.f;
  }
  __syncthreads();
  int from[5];
  from[0] = s;
#pragma unroll
  for (int r = 0; r < 4; ++r) from[1 + r] = (s >> 2) + r * hi;
  for (int t = 1; t <= T; ++t) {
    const float* Ac = A + ((t - 1) & 1) * S;
    const float* Vc = V + ((t - 1) & 1) * S;
    float u[5], v[5], alpha = kNegInf, mu = kNegInf, su = 0.f, mv = kNegInf;
    if (active) {
      const __half* row = base + (size_t)(t - 1) * row_stride + 4 * s;
      const uint2 raw = *reinterpret_cast<const uint2*>(row);
      const __half2 lo = *reinterpret_cast<const __half2*>(&raw.x);
      const __half2 hi2 = *reinterpret_cast<const __half2*>(&raw.y);
      const float m[5] = {blank, __low2float(lo), __high2float(lo),
                          __low2float(hi2), __high2float(hi2)};
      const float b = beta[(size_t)t * S + s];
      float am[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        am[j] = Ac[from[j]] + m[j];
        u[j] = am[j] + b;
        v[j] = Vc[from[j]];
      }
      alpha = lse5(am);
      mu = u[0];
#pragma unroll
      for (int j = 1; j < 5; ++j) mu = fmaxf(mu, u[j]);
#pragma unroll
      for (int j = 0; j < 5; ++j) su += expf(u[j] - mu);
      mv = Vc[s];
    }
    float ma = alpha;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      combine(mu, su, __shfl_xor_sync(0xffffffffu, mu, o),
              __shfl_xor_sync(0xffffffffu, su, o));
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
      mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
    }
    if (lane == 0) {
      red[warp][0] = mu;
      red[warp][1] = su;
      red[warp][2] = ma;
      red[warp][3] = mv;
    }
    __syncthreads();
    mu = red[0][0];
    su = red[0][1];
    ma = red[0][2];
    mv = red[0][3];
    for (int w = 1; w < n_warps; ++w) {
      combine(mu, su, red[w][0], red[w][1]);
      ma = fmaxf(ma, red[w][2]);
      mv = fmaxf(mv, red[w][3]);
    }
    if (active) {
      const float L = mu + logf(su);
      int jb = 0;
      float cb = kNegInf, pb = 0.f;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const float p = expf(u[j] - L);
        const float c = (v[j] - mv) + logf(p + 1e-8f);
        if (c > cb || j == 0) {
          cb = c;
          jb = j;
          pb = p;
        }
      }
      bpn[(size_t)(t - 1) * S + s] = (uint8_t)jb;
      if (qsn) {
        float q = rintf(log1pf(-fminf(pb, 1.f)) * kQScale);
        q = fminf(fmaxf(q, 1.f), 50.f);
        qsn[(size_t)(t - 1) * S + s] = (uint8_t)(33 + (int)q);
      }
      A[(t & 1) * S + s] = alpha - ma;
      V[(t & 1) * S + s] = cb;
    }
    __syncthreads();
  }

  // ---- the first state of largest V_T, then the traceback on one thread
  {
    float bv = active ? V[(T & 1) * S + s] : kNegInf;
    int bi = active ? s : S;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red[warp][0] = bv;
      red[warp][1] = __int_as_float(bi);
    }
    __syncthreads();
    if (s == 0) {
      for (int w = 1; w < n_warps; ++w) {
        const float ov = red[w][0];
        const int oi = __float_as_int(red[w][1]);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      best_s = bi;
    }
  }
  if (s != 0) return;
  int st = best_s;
  uint8_t* lab = labels + (size_t)n * T;
  uint8_t* qual = quals ? quals + (size_t)n * T : nullptr;
  for (int t = T; t >= 1; --t) {
    const int j = bpn[(size_t)(t - 1) * S + st];
    lab[t - 1] = (uint8_t)j;
    if (qual) qual[t - 1] = qsn[(size_t)(t - 1) * S + st];
    st = j == 0 ? st : (st >> 2) + (j - 1) * hi;
  }
}

}  // namespace

extern "C" int nr_crf_decode(const void* scores, int T, int N, int state_len,
                             float blank, void* betas, void* bp, void* qs,
                             void* labels, void* quals, void* stream) {
  if (state_len < 1 || state_len > 5 || T < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if ((qs == nullptr) != (quals == nullptr)) return (int)cudaErrorInvalidValue;
  const int S = 1 << (2 * state_len);
  const int threads = S < 32 ? 32 : S;
  const size_t smem = 4 * (size_t)S * sizeof(float);
  crf_decode_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const __half*)scores, T, N, state_len, blank, (float*)betas,
      (uint8_t*)bp, (uint8_t*)qs, (uint8_t*)labels, (uint8_t*)quals);
  return (int)cudaGetLastError();
}
