// One LSTM layer of Bonito's CRF-CTC encoder (features H = 384) for Hopper
// (sm_90a): the whole recurrence of a batch of chunks in one persistent
// launch, the recurrent weights on chip for every step.
//
// No TPU kernel corresponds: the JAX package has no basecaller. It replaces
// cuDNN's LSTM, which launched a recurrent GEMM and a cell kernel per step
// (two launches x 800 steps x 5 layers a batch) and a flip before and after
// each reversed layer. The plain version is ops/lstm.py lstm_layer_plain,
// whose arithmetic this kernel follows step by step.
//
// Inputs: xp fp16, the input projection x W_ih^T (one large product per
// layer, made by the wrapper): the row of step t and chunk g at t xp_st + g
// xp_sn rows of 4H, its columns in the packed (unit, gate) order 4 u + g
// with gates i, f, g, o; bias [4H] f32 (b_ih + b_hh) in
// the same order; wfrag, W_hh as the register images of wgmma's A operand
// (ops/lstm.py hh_fragments). Output y [T][n][H] fp16. A reversed layer
// walks t from T - 1 down to 0 and reads and writes each step in place, so
// no flip is needed. Per step and chunk, in f32:
//
//   gates = h_{t-1} W_hh^T (fp16 operands, f32 sums) + xp_t + bias
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
//
// with h_{-1} = c_{-1} = 0, c kept in f32 registers for the whole sequence
// and h_t rounded to fp16 (the next step's operand and the output). The
// nonlinearities are f32 on the MUFU unit (ex2.approx, rcp.approx; a few
// f32 ulps, about 1e-6 relative, against ~1e-3 for the fp16 h they feed),
// the four gates of a cell sharing one reciprocal (lstm_cell): 7 MUFU
// operations a cell instead of 10, which bound the cells' time.
//
// What bounds it on this card: latency. Each step is a 1,536 x 384 product
// per chunk that depends on the step before. One cluster of kCluster = 8
// CTAs owns NC chunks (64, 72 or 80: the wrapper picks the fewest that let
// every cluster be resident at once, so the grid is one wave and clusters
// never wait on each other; an H100 holds 15 clusters of 8, so 1,024
// chunks take 72). CTA r owns units 48 r .. 48 r + 47, i.e. 192 gate rows,
// as 3 warpgroups of 64 rows whose slice of W_hh (64 x 384 fp16) lives in
// registers as wgmma's A operand (96 registers a thread) for all T steps.
// The NC chunks are NC / PW pieces of PW (16 or 24) chunks. Per step each
// warpgroup runs an m64nPWk16 chain over K = 384 per piece, two in flight,
// against h_{t-1} of the piece in shared memory (wgmma's B, K-major core
// matrices [H / 8][PW][8]). Rows are packed so that a lane holds gates (i,
// f) or (g, o) of one unit, and one shuffle with lane ^ 16 gives each
// thread all four gates of one unit for half of its chunks. Each thread
// writes its h_t into its CTA's slice of the piece's next buffer; after a
// CTA barrier, lane 0 of seven warps sends that 6 x PW x 16-byte slice to
// the other seven CTAs with a bulk copy through distributed shared memory,
// completing on the receiver's mbarrier of that buffer, while the later
// pieces compute: the exchange of one piece overlaps the cells of the
// next. A CTA starts step t + 1 when its mbarrier has counted all the
// peers' slices: no cluster barrier per step. While it waits, the threads
// store the CTA's slice of h_t to y and prefetch step t + 2's input
// projection (this CTA's 384 bytes a chunk) with 16-byte cp.async into
// padded rows, waited for before step t + 1's last barrier. Double-buffered h needs no
// more: a CTA sends into a peer's buffer of step t + 1 only once it has all
// the peers' h_{t-1}, each sent after its sender's last read of that
// buffer. The last step sends nothing; one cluster barrier at the end
// keeps every CTA resident until all copies out of its shared memory have
// landed.
//
// Measured on an H100 80GB HBM3 (700 W) at 1,024 chunks x 800 steps: 3.3
// ms a layer beside 1.6 ms for its input projection (PERF.md).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kH = 384;                    // units (features)
constexpr int kCluster = 8;                // CTAs a cluster
constexpr int kUnits = kH / kCluster;      // 48 units a CTA
constexpr int kWGs = 3;                    // warpgroups a CTA, 16 units each
constexpr int kThreads = 128 * kWGs;
constexpr int kKT = kH / 16;               // k16 tiles of the recurrent product
constexpr int kGroups = kUnits / 8;        // 16-byte groups of units a CTA
constexpr uint32_t kSpinLimit = 1u << 26;  // a wait polled this often traps
constexpr int kXRow = kUnits * 4 * 2 + 16;  // a chunk's projection, padded

template <int NC>
__host__ __device__ constexpr size_t smem_bytes() {
  // two h buffers of NC chunks fp16, two prefetch stages of NC rows, two
  // mbarriers
  return 2 * (size_t)NC * kH * sizeof(__half) + 2 * (size_t)NC * kXRow + 16;
}

// ---- PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes from global into shared memory, zero-filled where bytes = 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)),
                  "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the shared::cluster address of the same location in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma's reads, the bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait that polls kSpinLimit times traps (a launch error, not a hang)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == kSpinLimit) __trap();
  }
}

// bytes (a multiple of 16) of this CTA's shared memory at src into a
// peer's at dst (shared::cluster), completing on the peer's mbarrier bar
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a shared-memory matrix descriptor of wgmma without swizzle: core
// matrices of 8 rows x 16 bytes; lbo: bytes between the two k halves of a
// k16 tile, sbo: bytes between groups of 8 rows
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// ties the accumulators to the wgmma instructions around them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A B: A 64x16 fp16 from registers (this warp's rows 16 w .. 16 w +
// 15 as mma.m16n8k16's A fragment), B 16xPW fp16 from a descriptor, d f32;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4],
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[12], const uint32_t (&a)[4],
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---- end of the PTX wrappers

// 2^x and 1 / x on the MUFU unit (denormal results flushed to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kGateFloor = -21.0f;       // 4 denominators of 1 + e^21 < 3.4e38

// One cell: c = sigmoid(f) c + sigmoid(i) tanh(g), returns sigmoid(o)
// tanh(c). The four gates share one reciprocal: with d_x = 1 + e^-x and
// tanh(g) = 2 / d_2g - 1, r = 1 / (d_i d_f d_2g d_o) and sigmoid(i) = r d_f
// d_2g d_o etc. Arguments below kGateFloor are raised to it (sigmoid(-21) =
// 7.6e-10) so that the product stays finite.
__device__ __forceinline__ float lstm_cell(float gi, float gf, float gg, float go,
                                           float& c) {
  const float di = 1.0f + ex2(-kLog2e * fmaxf(gi, kGateFloor));
  const float df = 1.0f + ex2(-kLog2e * fmaxf(gf, kGateFloor));
  const float dg = 1.0f + ex2(-2.0f * kLog2e * fmaxf(gg, 0.5f * kGateFloor));
  const float dout = 1.0f + ex2(-kLog2e * fmaxf(go, kGateFloor));
  const float dif = di * df, dgo = dg * dout;
  const float r = rcp(dif * dgo);
  const float si = r * df * dgo, sf = r * di * dgo, so = r * dif * dg;
  const float tg = 2.0f * (r * dif * dout) - 1.0f;
  c = sf * c + si * tg;
  const float tc = 2.0f * rcp(1.0f + ex2(-2.0f * kLog2e * c)) - 1.0f;
  return so * tc;
}

// One piece's chain: d = A [64 x 384] times the piece's PW chunks of
// h_{t-1} (desc: the piece's [H / 8][PW][8])
template <int PW>
__device__ __forceinline__ void piece_chain(float (&d)[PW / 2],
                                            const uint32_t (&a)[kKT][4],
                                            uint64_t desc) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kKT; ++k)
    wgmma(d, a[k], desc + ((uint64_t)(2 * k * PW * 16) >> 4), k > 0);
  wgmma_commit();
  fence_regs(d);
}

// grid: ceil(n / NC) clusters of kCluster CTAs; cluster k owns chunks
// k NC .. k NC + NC - 1 (those >= n are computed on zeros and not stored)
template <int NC, int PW>
__global__ void __launch_bounds__(kThreads, 1)
lstm_layer_kernel(const __half* __restrict__ xp, int xp_st, int xp_sn,
                  const float* __restrict__ bias, const uint4* __restrict__ wfrag,
                  __half* __restrict__ y, int T, int n, int reverse) {
  constexpr int kPieces = NC / PW;
  constexpr int kBlocks = PW / 8;                // n8 blocks of a piece
  constexpr int kCells = NC / 8;                 // cells a thread owns
  constexpr int kPieceHalves = kH * PW;          // a piece's h [H / 8][PW][8]
  constexpr int kSlice = kGroups * PW;           // 16-byte vectors of a piece's slice
  constexpr uint32_t kSliceBytes = 16 * kSlice;
  constexpr int kRowVecs = kUnits * 4 * 2 / 16;  // 16-byte vectors of a chunk's xp
  static_assert(NC % PW == 0 && kPieces >= 2, "two pieces in flight");
  extern __shared__ __align__(128) uint8_t smem[];
  __half* hbuf = reinterpret_cast<__half*>(smem);       // [2][kPieces][H/8][PW][8]
  uint8_t* xring = smem + 2 * NC * kH * 2;              // [2][NC][kXRow]
  const uint32_t bars = smem_u32(smem + smem_bytes<NC>() - 16);    // one per h buffer

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, wg = tid >> 7;
  const int q = lane >> 2, p = lane & 3, hi = q >> 2;
  const uint32_t rank = cluster_rank();
  const int n0 = (blockIdx.x / kCluster) * NC;
  // this thread's unit: rows q and q + 8 of its warp hold gates (i, f) of
  // unit q (q < 4) or (g, o) of unit q - 4
  const int local = 16 * wg + 4 * warp + (q & 3);
  const int unit = kUnits * (int)rank + local;

  uint32_t a[kKT][4];
  {
    const uint4* wf = wfrag + (size_t)((rank * kWGs + wg) * 4 + warp) * kKT * 32 + lane;
#pragma unroll
    for (int k = 0; k < kKT; ++k) {
      const uint4 v = wf[k * 32];
      a[k][0] = v.x;
      a[k][1] = v.y;
      a[k][2] = v.z;
      a[k][3] = v.w;
    }
  }
  const float4 b4 = *reinterpret_cast<const float4*>(bias + 4 * unit);
  float c[kCells];
#pragma unroll
  for (int e = 0; e < kCells; ++e) c[e] = 0.0f;

  // h_{-1} = 0
  for (int i = tid; i < NC * kH / 8; i += kThreads)
    reinterpret_cast<uint4*>(hbuf)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    fence_mbar_init();
  }

  // step s's input projection of this CTA's units, row chunk of stage s %
  // 2, 16 bytes a copy over all threads (zeros for chunks >= n)
  auto prefetch = [&](int s) {
    const int t = reverse ? T - 1 - s : s;
    uint8_t* dst = xring + (s & 1) * NC * kXRow;
    const __half* src = xp + (size_t)t * xp_st * 4 * kH + 4 * kUnits * rank;
    for (int v = tid; v < NC * kRowVecs; v += kThreads) {
      const int chunk = v / kRowVecs, part = v % kRowVecs;
      const int g = n0 + chunk;
      const bool ok = g < n;
      cp_async16(dst + chunk * kXRow + 16 * part,
                 src + (size_t)(ok ? g : 0) * xp_sn * 4 * kH + 8 * part, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // this CTA's slice of the step's h (buffer buf) to y
  auto store_y = [&](int s, int buf) {
    const int t = reverse ? T - 1 - s : s;
    __half* yt = y + (size_t)t * n * kH;
#pragma unroll
    for (int pc = 0; pc < kPieces; ++pc) {
      const uint4* mine = reinterpret_cast<const uint4*>(hbuf + (buf * kPieces + pc) *
                                                         kPieceHalves) + kGroups * rank * PW;
      for (int v = tid; v < kSlice; v += kThreads) {
        const int g = n0 + PW * pc + v % PW;
        if (g < n)
          *reinterpret_cast<uint4*>(yt + (size_t)g * kH + (kGroups * rank + v / PW) * 8) =
              mine[v];
      }
    }
  };
  prefetch(0);
  cp_async_wait<0>();
  fence_proxy_async();
  cluster_sync();                  // every CTA has started, zeroed h_{-1},
                                   // loaded step 0's projection and made its
                                   // mbarriers

  for (int s = 0; s < T; ++s) {
    const __half* hc = hbuf + (s & 1) * NC * kH;
    __half* hn = hbuf + ((s + 1) & 1) * NC * kH;
    const uint32_t bar_c = bars + 8 * (s & 1), bar_n = bars + 8 * ((s + 1) & 1);
    const bool send = s + 1 < T;
    if (tid == 0 && send) mbar_expect_tx(bar_n, (kCluster - 1) * kPieces * kSliceBytes);
    // while the peers' slices of h_{s-1} arrive: the next step's projection
    // and this CTA's slice of h_{s-1} to y
    if (send) prefetch(s + 1);
    if (s > 0) {
      store_y(s - 1, s & 1);
      mbar_wait(bar_c, ((s - 1) >> 1) & 1);
    }
    float acc[2][PW / 2];
    piece_chain<PW>(acc[0], a, smem_desc(hc, PW * 16, 128));
    piece_chain<PW>(acc[1], a, smem_desc(hc + kPieceHalves, PW * 16, 128));
    const uint8_t* xs = xring + (s & 1) * NC * kXRow + 8 * local;
#pragma unroll
    for (int pc = 0; pc < kPieces; ++pc) {
      float(&d)[PW / 2] = acc[pc & 1];
      if (pc + 1 < kPieces)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(d);
      __half* hp = hn + pc * kPieceHalves;
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
        const int e = kBlocks * pc + j;
        // accumulators of n8 block j: (row q, chunk 2p), (row q, 2p + 1),
        // (row q + 8, 2p), (row q + 8, 2p + 1); lo lanes keep chunk 2p, hi
        // lanes 2p + 1, and trade the other with lane ^ 16
        const float s1 = __shfl_xor_sync(0xffffffffu, hi ? d[4 * j] : d[4 * j + 1], 16);
        const float s2 = __shfl_xor_sync(0xffffffffu, hi ? d[4 * j + 2] : d[4 * j + 3], 16);
        float gi = hi ? s1 : d[4 * j], gf = hi ? s2 : d[4 * j + 2];
        float gg = hi ? d[4 * j + 1] : s1, go = hi ? d[4 * j + 3] : s2;
        const int chunk = 8 * j + 2 * p + hi;          // within the piece
        const uint2 raw = *reinterpret_cast<const uint2*>(xs + (PW * pc + chunk) * kXRow);
        const float2 xif = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
        const float2 xgo = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
        gi = (gi + xif.x) + b4.x;
        gf = (gf + xif.y) + b4.y;
        gg = (gg + xgo.x) + b4.z;
        go = (go + xgo.y) + b4.w;
        const __half h = __float2half_rn(lstm_cell(gi, gf, gg, go, c[e]));
        hp[(unit >> 3) * PW * 8 + chunk * 8 + (unit & 7)] = h;
      }
      if (pc + 2 < kPieces)
        piece_chain<PW>(acc[pc & 1], a, smem_desc(hc + (pc + 2) * kPieceHalves, PW * 16, 128));
      if (pc + 1 == kPieces && send) cp_async_wait<0>();   // step s + 1's projection
      fence_proxy_async();         // the slice's writes before the bulk copies
      __syncthreads();             // this CTA's slice of the piece is whole

      // the piece's slice to the seven peers (lane 0 of a warp each)
      if (send && lane == 0 && tid < 32 * (kCluster - 1)) {
        const uint32_t peer = (rank + 1 + tid / 32) % kCluster;
        const uint32_t mine = smem_u32(hp + kGroups * rank * PW * 8);
        bulk_to_peer(peer_addr(mine, peer), mine, kSliceBytes, peer_addr(bar_n, peer));
      }
    }
  }
  store_y(T - 1, T & 1);
  cluster_sync();                  // every copy out of this CTA has landed
}

template <int NC, int PW>
int launch(const void* xp, int xp_st, int xp_sn, const void* bias, const void* wfrag,
           void* y, int T, int n, int reverse, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      lstm_layer_kernel<NC, PW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<NC>());
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + NC - 1) / NC * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<NC>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lstm_layer_kernel<NC, PW>, (const __half*)xp, xp_st, xp_sn, (const float*)bias,
      (const uint4*)wfrag, (__half*)y, T, n, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NC, int PW>
int active_clusters() {
  if (cudaFuncSetAttribute(lstm_layer_kernel<NC, PW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<NC>()) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 256);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<NC>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int out = 0;
  if (cudaOccupancyMaxActiveClusters(&out, lstm_layer_kernel<NC, PW>, &cfg) != cudaSuccess)
    return -1;
  return out;
}

}  // namespace

// One layer: xp fp16 (step t, chunk g at row t xp_st + g xp_sn of 4H),
// bias [4H] f32, wfrag (the register images), y [T][n][H] fp16; nc the
// chunks a cluster (64, 72 or 80)
extern "C" int nr_lstm_layer(const void* xp, int xp_st, int xp_sn, const void* bias,
                             const void* wfrag, void* y, int T, int n, int reverse,
                             int nc, void* stream) {
  if (T < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nc) {
    case 64: return launch<64, 16>(xp, xp_st, xp_sn, bias, wfrag, y, T, n, reverse, st);
    case 72: return launch<72, 24>(xp, xp_st, xp_sn, bias, wfrag, y, T, n, reverse, st);
    case 80: return launch<80, 16>(xp, xp_st, xp_sn, bias, wfrag, y, T, n, reverse, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters at nc chunks a cluster (-1: an error)
extern "C" int nr_lstm_active_clusters(int nc) {
  switch (nc) {
    case 64: return active_clusters<64, 16>();
    case 72: return active_clusters<72, 24>();
    case 80: return active_clusters<80, 16>();
    default: return -1;
  }
}
