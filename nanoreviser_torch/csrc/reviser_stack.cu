// The reviser stack for Hopper (sm_90a): two kernels on one tensor-core
// core.
//
// stack_full replaces the TPU kernel _kernel_full (nanoreviser_tpu/ops/
// reviser_kernel.py:283, core _stack_core :92, entry stack_logits_full
// :678): one launch over (blocks of 16 windows, 2 models) runs the conv
// branch once per base row into shared memory, then the stack core.
//
// stack_windows replaces _kernel (:251, entries stack_logits_multi :611 and
// stack_logits_pallas :749), the same stack on pre-gathered per-window
// inputs: window w brings its own T rows, the features f [w][t][6] and the
// conv-branch output s [m][w][t][64], both f32. One launch over (blocks of
// 16 windows, M = 1 or 2 models) stages a block's rows in shared memory as
// bf16, then runs the stack core.
//
// The stack core (stack_core, parts c and d below), shared by both kernels:
// the 4 Bi-LSTM layers (H = 16/64/128/64, Keras hard_sigmoid gates, c in
// f32, h rounded to bf16 after every step, the backward pass t = T-1..0),
// each step one gate product  z = ((x_t @ wi + b) + s_t @ wis) + h @ wh
// where layer 1's x_t is the features of step t and layer 3's s_t the conv
// output of step t, then the per-t relu heads, the feature, the logits and
// the max prob; every product on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulation). The two kernels differ only in where step t
// of window w finds its rows: staged base row w + t in stack_full (a row
// step of 1), the window's own row t in stack_windows (a row step of 16,
// the rows stored [t][window]).
//
// What bounds stack_windows: operations, 6.21 M MACs per window and model
// at T = 11 (executed_mac_counts(t)["per_window_pregathered"]) against
// ~1.2 KB of input per window. What it meets first is, as for stack_full,
// the L2: every step of every block streams its layer's packed weights
// from L2 again, 12.33 MB per block and model at T = 11
// (stack_windows_fetch_bytes in ops/reviser_kernel.py). An FMA design (one
// thread per hidden unit, f32 on the CUDA cores, scalar bf16 weight loads)
// reached ~1% of the bound; this one runs the products on the tensor cores
// and the weights through stack_full's per-lane cp.async rings, so its
// time is that of the weight stream.

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

// ---------------------------------------------------------- the design
//
// Grid: (blocks of kG = 16 windows) x models, 256 threads = 8 warps.
// stack_full (window w covers base rows w .. w+T-1):
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
//
// stack_windows stages the block's features ([t][window][kLdF], k padded
// to 16) in buffer A past where layer 1 writes its output (layer 3, which
// overwrites them, no longer needs them) and the conv outputs of its model
// ([t][window][kLdX]) in a buffer of their own, both rounded to bf16;
// windows at or past n_win are zero and never written out. Then both run
// the stack core:
//
// c. the 4 Bi-LSTM layers, both directions at once (warps 0-3 the forward
//    pass, 4-7 the backward one), each step as one [16 windows x 4H] gate
//    product   z = ((x_t @ wi + b) + s_t @ wis) + h @ wh   where layer 1's
//    x_t is the features of step t (k 6, zero-padded to 16) and layer 3's
//    s_t the conv output of step t. So the layer-1 input and the layer-3
//    signal terms are computed per (window, t): in stack_full 13% more MACs
//    than hoisting them per row (executed_mac_counts: per_window_pregathered
//    against per_window), but on the tensor cores, and no f32 per-row
//    projection has to sit in shared memory (26 x 1,024 x 4 B = 106 KB of
//    p3 does not fit beside 140 KB of layer outputs at T = 11).
//    mma.sync m16n8k16 with the 16 windows as M: a warp owns groups of 8
//    hidden units and computes a group's four n8 tiles, one per gate, so
//    each thread holds i, f, c and o of the same (window, unit) pairs in
//    its accumulators and the gate math and c stay in registers (wgmma
//    would need the product transposed, 64 gate rows as M, for a 16-wide
//    N; mma.sync keeps the TPU kernel's per-step structure). Layer 3 (H =
//    128) gives each warp 4 groups, layers 2 and 4 two, layer 1 one (2
//    warps a direction). h is rounded to bf16 and stored row-major
//    ([t][window][unit]), the A operand of the next product (ldmatrix).
// d. the per-t heads as three products over all 16T (t, window) rows at
//    once: d1 = bf16(relu(l4 @ d1w + d1b)), d2 = bf16(relu(d1 @ d2w +
//    d2b)), m = bf16(relu(d2 @ mow + mob)); then on the CUDA cores acc +=
//    m_t @ fw[t], feature = bf16(relu(acc + fb)), logits = feature @ fow +
//    fob, probs = 1 / sum(exp(l - max)). Windows >= w_valid are not
//    written.
//
// What bounds stack_full: operations, 4.27e12 FLOP per full batch of
// 191,232 windows by the JAX package's algorithmic count (4.3 ms at 989
// TFLOP/s); its input and output are ~37 MB. What both kernels meet first
// is the L2: the LSTM weights (1 MB of fragments a model) do not fit in
// shared memory, so every step of every block streams its layer's weights
// from L2 again, 12.8 MB per block and model, 305 GB per full batch at
// T = 11 (stack_full_fetch_bytes in ops/reviser_kernel.py). So the weights
// are packed once per engine in the order a warp consumes them
// (pack_full_weights), and each lane copies its own 32 bytes of every 1 KB
// tile into its own slice of a per-warp ring in shared memory with
// cp.async, S - 1 = 3..7 tiles ahead and across the step barriers: no lane
// waits on another for weights, and 24-56 KB a block are in flight. The
// conv and head weights are read once per block (once per pair of m-tiles
// for the heads) straight from L2.
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
// rings. stack_full: 213,248 B at T = 11 (8-slot rings), 222,464 B at
// T = 13 (6-slot). stack_windows: 231,680 B at T = 11 (8-slot), 229,120 B
// at T = 13 (4-slot).

constexpr int kThreads = 256;
constexpr int kRows = 32;                // staged base rows per block
constexpr int kLdX = 72;                 // row strides (bf16 elements), each
constexpr int kLdF = 24;                 // an odd number of 16-byte units
constexpr int kLdZ = 408;
constexpr int kLdL1 = 40, kLdL2 = 136, kLdL3 = 264, kLdL4 = 136;
constexpr int kLdH1 = 136, kLdH2 = 40;
constexpr int kTile = 512;               // bf16 of one streamed weight tile
constexpr int kConvNT = kConv / 8;       // n8 tiles of z1 and z2
constexpr size_t kRingSlot = (size_t)(kThreads / 32) * kTile * sizeof(bf16);

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
// x [.][x_ld] (KX k16 tiles), s row (t * s_step + r) of s [.][s_ld] (KS
// tiles; the conv outputs), h of the previous step from out (KH tiles).
// out: [T][16][out_ld], direction d at columns [d*H, d*H + H). wpack: the
// layer's packed [2][H/8][KX+KS+KH][2][32][8]; bias [2][4H].
template <int H, int KX, int KS, int KH, int S>
__device__ __forceinline__ void lstm_layer(const bf16* x, int x_ld, int x_step,
                                           const bf16* s, int s_ld, int s_step,
                                           bf16* out, int out_ld,
                                           const bf16* wpack,
                                           const float* __restrict__ bias,
                                           int T, bf16* ring) {
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
      const bf16* sa = s + ((size_t)t * s_step + a_row) * s_ld + a_col;
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
       task += kThreads / 32) {
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

struct CoreWeights {  // one model, in CORE_ORDER of ops/reviser_kernel.py
  const bf16* l1; const float* b1; const bf16* l2; const float* b2;
  const bf16* l3; const float* b3; const bf16* l4; const float* b4;
  const uint2* d1; const float* d1b; const uint2* d2; const float* d2b;
  const uint2* mo; const float* mob;
  const bf16* fw; const float* fb; const bf16* fow; const float* fob;
};
constexpr int kCoreArgs = 18;

struct FullWeights {  // one model, in FULL_ORDER: the conv branch, the core
  const uint2* cw1; const float* cb1; const uint2* cw2; const float* cb2;
  const uint2* cc; const uint2* ce; const float* cbias;
  CoreWeights core;
};
constexpr int kConvArgs = 7, kFullArgs = kConvArgs + kCoreArgs;
struct FullPair { FullWeights m[2]; };
struct CorePair { CoreWeights m[2]; };

CoreWeights core_weights_of(const void* const* p) {
  return CoreWeights{
      (const bf16*)p[0], (const float*)p[1], (const bf16*)p[2],
      (const float*)p[3], (const bf16*)p[4], (const float*)p[5],
      (const bf16*)p[6], (const float*)p[7],
      (const uint2*)p[8], (const float*)p[9], (const uint2*)p[10],
      (const float*)p[11], (const uint2*)p[12], (const float*)p[13],
      (const bf16*)p[14], (const float*)p[15], (const bf16*)p[16],
      (const float*)p[17]};
}

// c. and d. for the block's 16 windows w0.. of model m: the features (layer
// 1's input) at row (t * f_step + r) of F [.][kLdF], the conv outputs
// (layer 3's signal input) at row (t * s_step + r) of SG [.][kLdX]. A
// [T][16][kLdL3] and B [T][16][kLdL2] hold the layer outputs (F may lie in
// A past [T][16][kLdL1], where layer 1 writes), then the heads' scratch.
template <int S>
__device__ __forceinline__ void stack_core(
    const CoreWeights& w, bf16* A, bf16* B, const bf16* F, int f_step,
    const bf16* SG, int s_step, int T, bf16* ring, int m, int w0,
    int w_valid, int n_windows, float* __restrict__ logits,
    float* __restrict__ probs) {
  const int tid = threadIdx.x;

  // c. the Bi-LSTM layers
  lstm_layer<kH1, 1, 0, 1, S>(F, kLdF, f_step, SG, kLdX, s_step, A, kLdL1,
                              w.l1, w.b1, T, ring);
  lstm_layer<kH2, 2, 0, 4, S>(A, kLdL1, kG, SG, kLdX, s_step, B, kLdL2,
                              w.l2, w.b2, T, ring);
  lstm_layer<kH3, 8, 4, 8, S>(B, kLdL2, kG, SG, kLdX, s_step, A, kLdL3,
                              w.l3, w.b3, T, ring);
  lstm_layer<kH4, 16, 0, 4, S>(A, kLdL3, kG, SG, kLdX, s_step, B, kLdL4,
                               w.l4, w.b4, T, ring);

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
__global__ void __launch_bounds__(kThreads, 1)
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
  for (int e = tid; e < kRows * 8; e += kThreads) {
    const int r = e >> 3, q = e & 7, row = w0 + r;
    bf16* dst = X + r * kLdX + q * 8;
    if (row < n_p) cp_async16(dst, sig + (size_t)row * kQP + q * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < kRows * 3; e += kThreads) {
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
  for (int e = tid; e < kRows * (kQP - kQ); e += kThreads)
    X[(e / (kQP - kQ)) * kLdX + kQ + e % (kQP - kQ)] = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < kRows * 16; e += kThreads) {
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

  // c. and d.: window w's step t reads base row w + t
  stack_core<S>(w.core, A, B, FB, 1, S64, 1, T, ring, m, w0, w_valid,
                n_windows, logits, probs);
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
stack_windows_kernel(CorePair wp, const float* __restrict__ feats,
                     const float* __restrict__ sig, int n_win, int T,
                     float* __restrict__ logits, float* __restrict__ probs) {
  const int m = blockIdx.y;
  const int w0 = blockIdx.x * kG;
  const int nv = min(kG, n_win - w0);
  const int tid = threadIdx.x, warp = tid >> 5;
  extern __shared__ uint4 smem_u4[];
  bf16* A = reinterpret_cast<bf16*>(smem_u4);              // [T][16][kLdL3]
  bf16* B = A + (size_t)T * kG * kLdL3;                     // [T][16][kLdL2]
  bf16* SG = B + (size_t)T * kG * kLdL2;                    // [T][16][kLdX]
  bf16* ring = SG + (size_t)T * kG * kLdX + (size_t)warp * S * kTile;
  bf16* F = A + (size_t)T * kG * kLdL1;                     // [T][16][kLdF]

  // the conv outputs of model m (16 float4 per (window, t), contiguous
  // over the block) and the features, as bf16 rows [t][window]
  const float4* sm =
      reinterpret_cast<const float4*>(sig + ((size_t)m * n_win + w0) * T * kQP);
  for (int e = tid; e < kG * T * 16; e += kThreads) {
    const int r = e / (T * 16), t = (e >> 4) % T, q = e & 15;
    const float4 v = r < nv ? __ldg(sm + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bf16* dst = SG + ((size_t)t * kG + r) * kLdX + 4 * q;
    put_bf16x2(dst, v.x, v.y);
    put_bf16x2(dst + 2, v.z, v.w);
  }
  for (int e = tid; e < kG * T * 16; e += kThreads) {
    const int r = e / (T * 16), t = (e >> 4) % T, k = e & 15;
    const float v = r < nv && k < 6 ? __ldg(feats + ((size_t)(w0 + r) * T + t) * 6 + k)
                                    : 0.0f;
    F[((size_t)t * kG + r) * kLdF + k] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // c. and d.: window w's step t reads its own row t
  stack_core<S>(wp.m[m], A, B, F, kG, SG, kG, T, ring, m, w0, n_win, n_win,
                logits, probs);
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
  stack_full_kernel<S><<<grid, kThreads, smem, stream>>>(
      wp, sig, feats, n_p, T, w_valid, n_windows, logits, probs);
  return (int)cudaGetLastError();
}

template <int S>
int launch_windows(const CorePair& wp, int n_models, const float* feats,
                   const float* sig, int n_win, int T, float* logits,
                   float* probs, cudaStream_t stream) {
  const size_t smem = (size_t)T * kG * (kLdL3 + kLdL2 + kLdX) * sizeof(bf16) +
                      S * kRingSlot;
  cudaError_t err = cudaFuncSetAttribute(
      stack_windows_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_win + kG - 1) / kG, n_models);
  stack_windows_kernel<S><<<grid, kThreads, smem, stream>>>(
      wp, feats, sig, n_win, T, logits, probs);
  return (int)cudaGetLastError();
}

}  // namespace

// The weight-ring slots per warp that nr_stack_windows takes at T: the most
// of 8, 6 or 4 that fit beside the layer outputs and the staged conv
// outputs; 0 if none fits (T > 13). The wrapper asks this, so the layout
// is decided here only.
extern "C" int nr_stack_windows_ring_slots(int T) {
  if (T < 1) return 0;
  const size_t fixed = (size_t)T * kG * (kLdL3 + kLdL2 + kLdX) * sizeof(bf16);
  for (int s = 8; s >= 4; s -= 2)
    if (fixed + s * kRingSlot <= kMaxSmem) return s;
  return 0;
}

// w: the CORE_ORDER pointers (ops/reviser_kernel.py) of model 0, then (with
// n_models = 2) those of model 1. feats f32 [n_win, T, 6], sig f32
// [n_models, n_win, T, 64] (16-byte aligned); logits f32 [n_models, n_win,
// 6], probs f32 [n_models, n_win] or null.
extern "C" int nr_stack_windows(const void* const* w, int n_models,
                                const float* feats, const float* sig,
                                int n_win, int T, float* logits, float* probs,
                                cudaStream_t stream) {
  if (n_models < 1 || n_models > 2 || n_win < 1)
    return (int)cudaErrorInvalidValue;
  CorePair wp = {};
  for (int m = 0; m < n_models; ++m)
    wp.m[m] = core_weights_of(w + m * kCoreArgs);
  switch (nr_stack_windows_ring_slots(T)) {
    case 8:
      return launch_windows<8>(wp, n_models, feats, sig, n_win, T, logits,
                               probs, stream);
    case 6:
      return launch_windows<6>(wp, n_models, feats, sig, n_win, T, logits,
                               probs, stream);
    case 4:
      return launch_windows<4>(wp, n_models, feats, sig, n_win, T, logits,
                               probs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
        (const float*)p[6], core_weights_of(p + kConvArgs)};
  }
  const size_t fixed = (size_t)T * kG * (kLdL3 + kLdL2) * sizeof(bf16) +
                       (size_t)kRows * (kLdX + kLdF) * sizeof(bf16) +
                       (size_t)kRows * 6 * sizeof(float);
  if (fixed + 8 * kRingSlot <= kMaxSmem)
    return launch_full<8>(wp, sig, feats, n_p, T, w_valid, n_windows, logits,
                          probs, fixed + 8 * kRingSlot, stream);
  if (fixed + 6 * kRingSlot <= kMaxSmem)
    return launch_full<6>(wp, sig, feats, n_p, T, w_valid, n_windows, logits,
                          probs, fixed + 6 * kRingSlot, stream);
  return (int)cudaErrorInvalidValue;
}
