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
// the weight stream: every step streams its layer's packed weights again
// (stack_windows_fetch_bytes in ops/reviser_kernel.py). Both kernels run
// as clusters of kCluster = 2 CTAs that split layers 2-4 by direction
// (the N-split, part c below), so each CTA streams half of those weights
// per step for twice the windows, through a ring that a producer warp
// fills.

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
// Grid: (blocks of kG = 16 windows) x models, 288 threads: 8 consumer warps
// (kConsumers = 256 threads) run everything below; warp 8, the producer,
// only fills the split layers' weight ring (part c). Nine warps leave 168
// registers a thread (three warps share an SM sub-partition). stack_full
// (window w covers base rows w .. w+T-1):
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
//    The N-split: the grid runs as clusters of kCluster = 2 CTAs along the
//    window blocks (both on one model). Layer 1 runs as above in each CTA
//    on its own 16 windows; layers 2-4 are split by direction: CTA d of the
//    pair runs direction d for the pair's 32 windows, two m16 tiles that
//    share every weight fragment, so it streams half of the layer's
//    weights per step for twice the windows (a warp owns H/64 groups). Its
//    own tile reads its own rows as above; the peer's tile reads the peer's
//    x_t and s_t rows, copied each step from the peer's shared memory
//    (distributed shared memory, ld through mapa) into P [16][ldP] of its
//    own, and h of the previous step from M [2][16][ldM], where the CTA
//    keeps the peer windows' h of its direction (by step parity). The h of
//    the peer's windows is also stored into the peer's layer output (st
//    through mapa), where the next layer and the heads find it. A cluster
//    barrier ends each layer; within a layer the two directions need
//    nothing of each other. The products of a (window, unit), their k
//    order and every rounding are those of the unsplit layer, so the
//    logits are bit-identical to it.
//    The split layers' weights come through one ring per CTA of S slots
//    of kFill = 16 KB (two 1 KB tiles of every consumer warp: the next two
//    of its per-step sequence), which the producer warp fills with one
//    cp.async.bulk each, ahead of use and across step and layer
//    boundaries, on full and empty mbarriers. A consumer warp waits for a
//    fill, loads its two tiles' B fragments into registers and releases
//    the slot at once. (Layer 3's two groups a warp run one after the
//    other: with their k chains interleaved on one pair of A fragments the
//    accumulators of both spilled at 168 registers.) (A probe kernel
//    found wgmma no faster than this mma.sync loop at 32 windows: with the
//    weights as its 64-row A operand every product re-reads its A tile
//    from shared memory. Its fills from one producer warp peak with 16 KB
//    bulk copies.) The ring's memory holds layer 1's per-warp rings while
//    layer 1 runs; the producer starts when layer 1 ends.
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
// is the weight stream: the LSTM weights (1 MB of fragments a model) do
// not fit in shared memory, so every step streams its layer's weights from
// L2 again: 12.8 MB per block and model unsplit, 305 GB per full batch at
// T = 11, 6.8 MB and 162 GB with the N-split (stack_full_fetch_bytes in
// ops/reviser_kernel.py). So the weights are packed once per engine in the
// order the block consumes them (pack_full_weights): layer 1 per warp,
// each lane copying its own 32 bytes of every 1 KB tile into its own slice
// of a per-warp ring with cp.async, 2S - 1 tiles ahead; layers 2-4 per
// 16 KB fill of the producer's ring. (A probe of the
// stream found TMA bulk copies of 1-2 KB fills, multicast or
// not, slower per SM than per-lane copies: so the split, and not
// multicast, is what cuts the bytes per window.) The conv and head
// weights are read once per block (once per pair of m-tiles for the
// heads) straight from L2.
//
// Packed products (pack_full_weights): the B fragments of mma.m16n8k16.
// For W [K, N], n8 tile n, k16 tile k, lane l = 4g + i:
//   [n][k][l] = (W[16k+2i][8n+g], W[16k+2i+1][8n+g], W[16k+2i+8][8n+g],
//                W[16k+2i+9][8n+g])
// and for an LSTM layer, direction d and unit group u, the k-tiles of its
// segments (wi, [wis,] wh) in turn, each as two halves of gate pairs:
//   tile [g / 2][l][g % 2][4], gate g's n8 tile = columns g*H + 8u .. +7,
// layer 1 as [d][u][tile] (l1_f), layers 2-4 as [d][fill][warp][2 tiles]
// (l2_r, l3_r, l4_r): warp w's two tiles of fill f are tiles 2f and 2f + 1
// of its groups' tiles in turn (group wQ's, then wQ + 1's, Q = H/64).
//
// Shared memory: layer outputs A [T][16][264] (layers 1, 3) and B
// [T][16][136] (layers 2, 4), bf16, rows padded by 16 bytes so that the 8
// row reads of an ldmatrix phase hit distinct banks; the staged rows; the
// peer's rows P and h M, their strides per layer; the ring and its
// barriers. stack_full: 228,416 B at T = 11 (4 slots), 221,216 B at T =
// 13 (2). stack_windows: 230,448 B at T = 11 (3), 227,856 B at T = 13
// (1).

constexpr int kConsumers = 256;          // warps 0-7: all but the ring's fills
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // warp 8: the producer
constexpr int kCluster = 2;              // CTAs per cluster (the N-split)
static_assert(kCluster == 2, "the N-split gives each CTA of a pair one direction");
constexpr int kRows = 32;                // staged base rows per block
constexpr int kLdX = 72;                 // row strides (bf16 elements), each
constexpr int kLdF = 24;                 // an odd number of 16-byte units
constexpr int kLdZ = 408;
constexpr int kLdL1 = 40, kLdL2 = 136, kLdL3 = 264, kLdL4 = 136;
constexpr int kLdH1 = 136, kLdH2 = 40;
constexpr int kTile = 512;               // bf16 of one streamed weight tile
constexpr int kConvNT = kConv / 8;       // n8 tiles of z1 and z2
constexpr int kFill = 16384;             // bytes of a ring slot: 2 tiles a warp
static_assert(kFill == kConsumerWarps * 2 * kTile * (int)sizeof(bf16), "");
constexpr size_t kRingSlot = kFill + 16;   // a slot and its two barriers
constexpr uint32_t kSpinLimit = 1u << 26;  // a wait polled this often traps

// A split layer's copies of the peer's rows: P [16][ldP] (x, then s) and M
// [2][16][ldM] (h by step parity), strides an odd number of 16-byte units
__host__ __device__ constexpr int peer_ldp(int kx, int ks) { return (kx + ks) * 16 + 8; }
__host__ __device__ constexpr int peer_ldm(int h) { return h + 8; }
__host__ __device__ constexpr int peer_elems(int kx, int ks, int h) {
  return kG * peer_ldp(kx, ks) + 2 * kG * peer_ldm(h);
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr size_t kPeerBytes =
    sizeof(bf16) * cmax(peer_elems(2, 0, kH2),
                        cmax(peer_elems(8, 4, kH3), peer_elems(16, 0, kH4)));

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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both CTAs: orders shared-memory accesses, local and
// remote, across the cluster; arrive and wait may be split (the producer)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the consumer warps alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// named barrier 2: the consumers arrive when layer 1 is done with the
// ring's memory, the producer warp waits for that
__device__ __forceinline__ void layer1_done_arrive() {
  asm volatile("bar.arrive 2, %0;\n" :: "n"(kThreads) : "memory");
}
__device__ __forceinline__ void layer1_done_wait() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(kThreads) : "memory");
}

// orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (the bulk copies)
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// bytes (a multiple of 16, 16-byte aligned) from global memory into shared
// memory at dst, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the generic address of the same shared-memory location in CTA `rank`
template <typename T>
__device__ __forceinline__ T* peer_ptr(T* p, uint32_t rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
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
    consumer_sync();
  }
  cp_async_wait<0>();
}

// The split layers' weight ring: S slots of kFill bytes at `slots`, slot s
// with a full barrier at bars + 8 s (count 1: the producer's expect_tx,
// completed by the bytes of its bulk copy) and an empty barrier at bars +
// 8 (S + s) (count kConsumerWarps: one arrival a consumer warp once its
// tiles are in registers). Fill n goes to slot n % S in the phase of
// parity (n / S) & 1; every thread counts the fills it takes part in.
template <int S>
struct Ring {
  unsigned char* slots;
  uint32_t bars;
  uint32_t n;

  // thread 0, before the block's first barrier
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kConsumerWarps);
    }
    fence_mbar_init();
  }

  // the producer warp (all lanes): lane 0 fills slot n % S with the kFill
  // bytes at src once the consumers have released its previous fill
  __device__ __forceinline__ void fill(const bf16* src) {
    if ((threadIdx.x & 31) == 0) {
      const uint32_t s = n % S, k = n / S, full = bars + 8 * s;
      if (k > 0) mbar_wait(bars + 8 * (S + s), (k - 1) & 1);
      mbar_expect_tx(full, kFill);
      bulk_copy(smem_u32(slots + (size_t)s * kFill), src, kFill, full);
    }
    ++n;
  }

  // a consumer warp: this lane's B fragments of the warp's two tiles of
  // fill n (tile t, gate g: b[t][2g], b[t][2g + 1]), then the slot released
  __device__ __forceinline__ void take(uint32_t (&b)[2][8]) {
    const uint32_t s = n % S;
    mbar_wait(bars + 8 * s, (n / S) & 1);
    const uint4* p = reinterpret_cast<const uint4*>(
        slots + (size_t)s * kFill + (threadIdx.x >> 5) * 2 * kTile * sizeof(bf16)) +
        (threadIdx.x & 31);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint4 lo = p[t * 64], hi = p[t * 64 + 32];
      b[t][0] = lo.x; b[t][1] = lo.y; b[t][2] = lo.z; b[t][3] = lo.w;
      b[t][4] = hi.x; b[t][5] = hi.y; b[t][6] = hi.z; b[t][7] = hi.w;
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (S + s));
    ++n;
  }
};

// acc[i][g] += A_i @ (gate g's n8 tile) over K k16 tiles for the two m16
// tiles i (a_lane[i]: this lane's ldmatrix address in the first k tile),
// each weight fragment used for both, the tiles taken from the ring two a
// fill; per accumulator the same k order as gate_tiles. With S > 1 slots
// the next fill's fragments are taken before this fill's products, so
// their wait and loads overlap the products (with one slot that fill is
// only requested once this one is released).
template <int K, int S>
__device__ __forceinline__ void gate_chain(const bf16* a0_lane,
                                           const bf16* a1_lane, bool zero_a,
                                           Ring<S>& ring, float (&acc)[2][4][4]) {
  static_assert(K % 2 == 0, "a fill holds two k tiles of a group");
  constexpr bool kAhead = S > 1;
  uint32_t b[2][8], nb[2][8];
  if (kAhead) ring.take(b);
#pragma unroll
  for (int f = 0; f < K / 2; ++f) {
    const bool more = f + 1 < K / 2;
    if (!kAhead) ring.take(b);
    else if (more) ring.take(nb);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kt = 2 * f + j;
      uint32_t a0[4] = {0u, 0u, 0u, 0u}, a1[4] = {0u, 0u, 0u, 0u};
      if (!zero_a) {
        ldsm_x4(a0, a0_lane + kt * 16);
        ldsm_x4(a1, a1_lane + kt * 16);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        mma_bf16(acc[0][g], a0, b[j][2 * g], b[j][2 * g + 1]);
        mma_bf16(acc[1][g], a1, b[j][2 * g], b[j][2 * g + 1]);
      }
    }
    if (kAhead && more) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) b[j][e] = nb[j][e];
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&a)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][g][e] = 0.0f;
}

// fills a step of a split layer: a warp's Q = H / 64 groups x the layer's
// k16 tiles, two tiles a fill
template <int H, int KX, int KS, int KH>
__host__ __device__ constexpr int split_fills() {
  return (H / 64) * (KX + KS + KH) / 2;
}

// The producer's part of a split layer: every fill of its T steps, in the
// order the consumers take them (wpack: [2 directions][fills][kFill]).
template <int H, int KX, int KS, int KH, int S>
__device__ __forceinline__ void produce_layer(Ring<S>& ring, const bf16* wpack,
                                              int T, int dir) {
  constexpr int NF = split_fills<H, KX, KS, KH>();
  const bf16* src = wpack + (size_t)dir * NF * (kFill / sizeof(bf16));
  for (int st = 0; st < T; ++st)
    for (int f = 0; f < NF; ++f) ring.fill(src + (size_t)f * (kFill / sizeof(bf16)));
}

// One Bi-LSTM layer (hidden size H, layers 2-4) split over the cluster by
// direction, the consumer warps' part: this CTA runs direction `dir` for
// its own 16 windows (m tile 0: x, s, h rows in its own buffers, as
// lstm_layer reads them) and its peer's 16 (m tile 1). The peer's x and s
// rows of step t are copied from x_peer / s_peer (the same buffers in the
// peer CTA) into P [16][ldP] (x at columns 0.., s after KX k16 tiles); the
// peer windows' h is kept in M [parity of the step][16][ldM] (P and M at
// PM). h goes to out (own windows) and to out_peer and M (the peer's). A
// warp owns Q = H/64 groups of 8 units; the weights come from the ring.
// Ends with a cluster barrier, after which both CTAs' outputs hold both
// directions.
template <int H, int KX, int KS, int KH, int S>
__device__ __forceinline__ void lstm_layer_split(
    const bf16* x, const bf16* x_peer, int x_ld, int x_step, const bf16* s,
    const bf16* s_peer, int s_ld, int s_step, bf16* out, bf16* out_peer,
    int out_ld, bf16* PM, const float* __restrict__ bias, int T,
    Ring<S>& ring, int dir) {
  constexpr int Q = H / 64, LDP = peer_ldp(KX, KS), LDM = peer_ldm(H);
  constexpr int XU = KX * 2, SU = KS * 2;        // 16-byte units of a row
  static_assert(Q >= 1 && peer_elems(KX, KS, H) * sizeof(bf16) <= kPeerBytes, "");
  bf16* P = PM;
  bf16* M = PM + kG * LDP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = warp * Q;
  const int gq = lane >> 2, tq = lane & 3;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const float* bd = bias + dir * 4 * H;
  float c[Q][2][4];
  float2 bv[Q][4];   // this lane's biases, the same every step
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[q][i][e] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      bv[q][g] = __ldg(reinterpret_cast<const float2*>(bd + g * H + (u0 + q) * 8 + 2 * tq));
  }

  for (int st = 0; st < T; ++st) {
    const int t = dir ? T - 1 - st : st;
    const int tp = st == 0 ? t : (dir ? t + 1 : t - 1);
    for (int e = tid; e < kG * (XU + SU); e += kConsumers) {
      const int r = e / (XU + SU), q = e % (XU + SU);
      const uint4* src =
          q < XU ? reinterpret_cast<const uint4*>(
                       x_peer + ((size_t)t * x_step + r) * x_ld) + q
                 : reinterpret_cast<const uint4*>(
                       s_peer + ((size_t)t * s_step + r) * s_ld) + (q - XU);
      reinterpret_cast<uint4*>(P + r * LDP)[q] = *src;
    }
    consumer_sync();
    const bf16* xa = x + ((size_t)t * x_step + a_row) * x_ld + a_col;
    const bf16* sa = s + ((size_t)t * s_step + a_row) * s_ld + a_col;
    const bf16* ha = out + ((size_t)tp * kG + a_row) * out_ld + dir * H + a_col;
    const bf16* pa = P + a_row * LDP + a_col;
    const bf16* ma = M + ((size_t)((st + 1) & 1) * kG + a_row) * LDM + a_col;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int col = (u0 + q) * 8 + 2 * tq;   // this lane's first unit
      float acc[2][4][4], part[2][4][4];
      zero_acc(acc);
      gate_chain<KX>(xa, pa, false, ring, acc);
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][g][0] += bv[q][g].x; acc[i][g][1] += bv[q][g].y;
          acc[i][g][2] += bv[q][g].x; acc[i][g][3] += bv[q][g].y;
        }
      if constexpr (KS > 0) {
        zero_acc(part);
        gate_chain<KS>(sa, pa + KX * 16, false, ring, part);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][g][e] += part[i][g][e];
      }
      zero_acc(part);
      gate_chain<KH>(ha, ma, st == 0, ring, part);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // accumulator e: window gq (e < 2) or gq + 8, unit col + (e & 1)
        float hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ig = hard_sigmoid(acc[i][0][e] + part[i][0][e]);
          const float fg = hard_sigmoid(acc[i][1][e] + part[i][1][e]);
          const float gg = tanhf(acc[i][2][e] + part[i][2][e]);
          const float og = hard_sigmoid(acc[i][3][e] + part[i][3][e]);
          c[q][i][e] = fg * c[q][i][e] + ig * gg;
          hv[e] = og * tanhf(c[q][i][e]);
        }
        const size_t o = ((size_t)t * kG + gq) * out_ld + dir * H + col;
        if (i == 0) {
          put_bf16x2(out + o, hv[0], hv[1]);
          put_bf16x2(out + o + 8 * out_ld, hv[2], hv[3]);
        } else {
          bf16* m = M + ((size_t)(st & 1) * kG + gq) * LDM + col;
          put_bf16x2(m, hv[0], hv[1]);
          put_bf16x2(m + 8 * LDM, hv[2], hv[3]);
          put_bf16x2(out_peer + o, hv[0], hv[1]);
          put_bf16x2(out_peer + o + 8 * out_ld, hv[2], hv[3]);
        }
      }
    }
    consumer_sync();
  }
  cluster_sync();
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
#pragma unroll
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
       task += kConsumerWarps) {
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

// The producer warp's part of the stack core: once layer 1 has left the
// ring's memory, every fill of layers 2-4 in turn, taking part in the
// cluster barriers that end layer 1 and each split layer (an arrival right
// after a layer's last fill is issued, the wait before the next arrival),
// so its fills run ahead across the layer boundaries.
template <int S>
__device__ __forceinline__ void stack_producer(const CoreWeights& w, int T,
                                               Ring<S>& ring) {
  const int dir = (int)cluster_rank();
  layer1_done_wait();
  cluster_sync();                          // the end of layer 1
  produce_layer<kH2, 2, 0, 4, S>(ring, w.l2, T, dir);
  __syncwarp();
  cluster_arrive();                        // the end of layer 2
  produce_layer<kH3, 8, 4, 8, S>(ring, w.l3, T, dir);
  __syncwarp();
  cluster_wait();
  cluster_arrive();                        // the end of layer 3
  produce_layer<kH4, 16, 0, 4, S>(ring, w.l4, T, dir);
  __syncwarp();
  cluster_wait();
  cluster_sync();                          // the end of layer 4
}

// c. and d. for the block's 16 windows w0.. of model m, the consumer
// warps' part: the features (layer 1's input) at row (t * f_step + r) of F
// [.][kLdF], the conv outputs (layer 3's signal input) at row (t * s_step
// + r) of SG [.][kLdX]. A [T][16][kLdL3] and B [T][16][kLdL2] hold the
// layer outputs (F may lie in A past [T][16][kLdL1], where layer 1 writes),
// then the heads' scratch. PM: the split layers' copies of the peer's
// rows. Layer 1 streams its weights through per-warp rings of 2S 1 KB
// slots in the ring's memory. Every CTA of the cluster runs all of it,
// whatever its windows (none may leave early).
template <int S>
__device__ __forceinline__ void stack_core(
    const CoreWeights& w, bf16* A, bf16* B, const bf16* F, int f_step,
    const bf16* SG, int s_step, int T, bf16* PM, Ring<S>& ring, int m,
    int w0, int w_valid, int n_windows, float* __restrict__ logits,
    float* __restrict__ probs) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const uint32_t dir = cluster_rank(), peer = dir ^ 1;
  bf16* Ap = peer_ptr(A, peer);
  bf16* Bp = peer_ptr(B, peer);
  const bf16* SGp = peer_ptr(SG, peer);

  // c. the Bi-LSTM layers: layer 1 on the own windows, 2-4 split
  lstm_layer<kH1, 1, 0, 1, 2 * S>(
      F, kLdF, f_step, SG, kLdX, s_step, A, kLdL1, w.l1, w.b1, T,
      reinterpret_cast<bf16*>(ring.slots) + (size_t)warp * 2 * S * kTile);
  fence_proxy_async();   // layer 1's copies and reads before the bulk fills
  layer1_done_arrive();
  cluster_sync();
  lstm_layer_split<kH2, 2, 0, 4, S>(A, Ap, kLdL1, kG, SG, SGp, kLdX, s_step,
                                    B, Bp, kLdL2, PM, w.b2, T, ring, dir);
  lstm_layer_split<kH3, 8, 4, 8, S>(B, Bp, kLdL2, kG, SG, SGp, kLdX, s_step,
                                    A, Ap, kLdL3, PM, w.b3, T, ring, dir);
  lstm_layer_split<kH4, 16, 0, 4, S>(A, Ap, kLdL3, kG, SG, SGp, kLdX, s_step,
                                     B, Bp, kLdL4, PM, w.b4, T, ring, dir);

  // d. the heads over the 16T (t, window) rows of layer 4's output
  const int R = kG * T;
  bf16* H1 = A;                                               // [R][kLdH1]
  bf16* H2 = H1 + (size_t)R * kLdH1;                          // [R][kLdH2]
  float* MO = reinterpret_cast<float*>(H2 + (size_t)R * kLdH2);  // [R][8]
  float* FE = MO + R * 8;                                     // [16][kG]
  dense_tiles<8>(B, kLdL4, T, w.d1, 128 / 8, ReluBf16{H1, kLdH1, w.d1b});
  consumer_sync();
  dense_tiles<8>(H1, kLdH1, T, w.d2, 32 / 8, ReluBf16{H2, kLdH2, w.d2b});
  consumer_sync();
  dense_tiles<2>(H2, kLdH2, T, w.mo, 1, MainOut{MO, w.mob});
  consumer_sync();
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
  consumer_sync();
  logits_out(FE, w.fow, w.fob, m, w0, w_valid, n_windows, logits, probs);
}

// The ring after the fixed part of the shared memory (`base`), its
// barriers after its slots; thread 0 initializes them, then the block
// meets once, the last barrier of all kThreads threads.
template <int S>
__device__ __forceinline__ Ring<S> ring_at(unsigned char* base) {
  Ring<S> ring{base, smem_u32(base + (size_t)S * kFill), 0u};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  return ring;
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
  bf16* PM = reinterpret_cast<bf16*>(FS + kRows * 6);       // P, M
  Ring<S> ring = ring_at<S>(reinterpret_cast<unsigned char*>(PM) + kPeerBytes);
  if (warp == kConsumerWarps) {
    stack_producer<S>(w.core, T, ring);
    return;
  }
  // the conv branch's scratch, in A (and B at small T) before layer 1
  bf16* X = A;                                              // [kRows][kLdX]
  bf16* Z1 = X + kRows * kLdX;                              // [kRows][kLdZ]
  bf16* Z2 = Z1 + kRows * kLdZ;                             // [kRows][kLdZ]

  // a. stage the rows
  for (int e = tid; e < kRows * 8; e += kConsumers) {
    const int r = e >> 3, q = e & 7, row = w0 + r;
    bf16* dst = X + r * kLdX + q * 8;
    if (row < n_p) cp_async16(dst, sig + (size_t)row * kQP + q * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < kRows * 3; e += kConsumers) {
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
  consumer_sync();
  // signal columns 50..63 are not the model's; features to bf16, k padded
  for (int e = tid; e < kRows * (kQP - kQ); e += kConsumers)
    X[(e / (kQP - kQ)) * kLdX + kQ + e % (kQP - kQ)] = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < kRows * 16; e += kConsumers) {
    const int r = e >> 4, k = e & 15;
    FB[r * kLdF + k] = __float2bfloat16_rn(k < 6 ? FS[r * 6 + k] : 0.0f);
  }
  consumer_sync();

  // b. the conv branch, per row
  dense_tiles<4>(X, kLdX, 2, w.cw1, kConvNT, ReluBf16{Z1, kLdZ, w.cb1});
  consumer_sync();
  dense_tiles<25>(Z1, kLdZ, 2, w.cw2, kConvNT, ReluBf16{Z2, kLdZ, w.cb2});
  consumer_sync();
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
  consumer_sync();

  // c. and d.: window w's step t reads base row w + t
  stack_core<S>(w.core, A, B, FB, 1, S64, 1, T, PM, ring, m, w0, w_valid,
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
  bf16* PM = SG + (size_t)T * kG * kLdX;                    // P, M
  bf16* F = A + (size_t)T * kG * kLdL1;                     // [T][16][kLdF]
  Ring<S> ring = ring_at<S>(reinterpret_cast<unsigned char*>(PM) + kPeerBytes);
  if (warp == kConsumerWarps) {
    stack_producer<S>(wp.m[m], T, ring);
    return;
  }

  // the conv outputs of model m (16 float4 per (window, t), contiguous
  // over the block) and the features, as bf16 rows [t][window]
  const float4* sm =
      reinterpret_cast<const float4*>(sig + ((size_t)m * n_win + w0) * T * kQP);
  for (int e = tid; e < kG * T * 16; e += kConsumers) {
    const int r = e / (T * 16), t = (e >> 4) % T, q = e & 15;
    const float4 v = r < nv ? __ldg(sm + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bf16* dst = SG + ((size_t)t * kG + r) * kLdX + 4 * q;
    put_bf16x2(dst, v.x, v.y);
    put_bf16x2(dst + 2, v.z, v.w);
  }
  for (int e = tid; e < kG * T * 16; e += kConsumers) {
    const int r = e / (T * 16), t = (e >> 4) % T, k = e & 15;
    const float v = r < nv && k < 6 ? __ldg(feats + ((size_t)(w0 + r) * T + t) * 6 + k)
                                    : 0.0f;
    F[((size_t)t * kG + r) * kLdF + k] = __float2bfloat16_rn(v);
  }
  consumer_sync();

  // c. and d.: window w's step t reads its own row t
  stack_core<S>(wp.m[m], A, B, F, kG, SG, kG, T, PM, ring, m, w0, n_win,
                n_win, logits, probs);
}

// Launches `kernel` on grid (blocks, models), blocks rounded up to whole
// clusters of kCluster CTAs along x. A refused launch (the cluster does not
// fit, too much shared memory) returns its error: there is no launch
// without clusters.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int blocks, int models,
                    size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + kCluster - 1) / kCluster * kCluster, models);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of `kernel` at smem bytes (-1: an error)
template <typename... Params>
int active_clusters(void (*kernel)(Params...), size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 256);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// Shared memory of each kernel at T without the ring, and the ring slots it
// takes: the most of the instantiated depths that fit (0: none)
size_t full_fixed(int T) {
  return (size_t)T * kG * (kLdL3 + kLdL2) * sizeof(bf16) +
         (size_t)kRows * (kLdX + kLdF) * sizeof(bf16) +
         (size_t)kRows * 6 * sizeof(float) + kPeerBytes;
}

size_t windows_fixed(int T) {
  return (size_t)T * kG * (kLdL3 + kLdL2 + kLdX) * sizeof(bf16) + kPeerBytes;
}

int ring_slots(size_t fixed, const int (&depths)[3]) {
  for (int s : depths)
    if (s > 0 && fixed + s * kRingSlot <= kMaxSmem) return s;
  return 0;
}

constexpr int kFullDepths[3] = {4, 3, 2};
constexpr int kWindowsDepths[3] = {3, 2, 1};

template <int S>
int launch_full(const FullPair& wp, const bf16* sig, const float* feats,
                int n_p, int T, int w_valid, int n_windows, float* logits,
                float* probs, cudaStream_t stream) {
  return launch_clusters(stack_full_kernel<S>, (w_valid + kG - 1) / kG, 2,
                         full_fixed(T) + S * kRingSlot, stream, wp, sig,
                         feats, n_p, T, w_valid, n_windows, logits, probs);
}

template <int S>
int launch_windows(const CorePair& wp, int n_models, const float* feats,
                   const float* sig, int n_win, int T, float* logits,
                   float* probs, cudaStream_t stream) {
  return launch_clusters(stack_windows_kernel<S>, (n_win + kG - 1) / kG,
                         n_models, windows_fixed(T) + S * kRingSlot, stream,
                         wp, feats, sig, n_win, T, logits, probs);
}

}  // namespace

// CTAs per cluster of both kernels (the N-split's pair), fixed here; the
// wrapper reads it for its byte counts and never chooses it.
extern "C" int nr_stack_cluster_size() { return kCluster; }

// The 16 KB slots of the weight ring that nr_stack_windows takes at T: the
// most of 3, 2 or 1 that fit beside the layer outputs, the staged conv
// outputs and the peer's rows; 0 if none fits (T > 13). The wrapper asks
// this, so the layout is decided here only.
extern "C" int nr_stack_windows_ring_slots(int T) {
  return T < 1 ? 0 : ring_slots(windows_fixed(T), kWindowsDepths);
}

// The same for nr_stack_full: 4, 3 or 2 (T <= 13), 0 past that.
extern "C" int nr_stack_full_ring_slots(int T) {
  return T < 5 || kG + T - 1 > kRows ? 0 : ring_slots(full_fixed(T), kFullDepths);
}

// Dynamic shared memory of a launch of stack_full (kernel 0) or
// stack_windows (kernel 1) at T, ring included (0 if T has no ring).
extern "C" int nr_stack_smem_bytes(int kernel, int T) {
  const int s = kernel == 0 ? nr_stack_full_ring_slots(T) : nr_stack_windows_ring_slots(T);
  if (s == 0) return 0;
  return (int)((kernel == 0 ? full_fixed(T) : windows_fixed(T)) + s * kRingSlot);
}

// cudaOccupancyMaxActiveClusters of stack_full (kernel 0) or stack_windows
// (kernel 1) at T: how many clusters the card holds at once (-1 if T has
// no ring or the query fails).
extern "C" int nr_stack_active_clusters(int kernel, int T) {
  const size_t smem = (size_t)nr_stack_smem_bytes(kernel, T);
  if (kernel == 0) {
    switch (nr_stack_full_ring_slots(T)) {
      case 4: return active_clusters(stack_full_kernel<4>, smem);
      case 3: return active_clusters(stack_full_kernel<3>, smem);
      case 2: return active_clusters(stack_full_kernel<2>, smem);
      default: return -1;
    }
  }
  switch (nr_stack_windows_ring_slots(T)) {
    case 3: return active_clusters(stack_windows_kernel<3>, smem);
    case 2: return active_clusters(stack_windows_kernel<2>, smem);
    case 1: return active_clusters(stack_windows_kernel<1>, smem);
    default: return -1;
  }
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
    case 3:
      return launch_windows<3>(wp, n_models, feats, sig, n_win, T, logits,
                               probs, stream);
    case 2:
      return launch_windows<2>(wp, n_models, feats, sig, n_win, T, logits,
                               probs, stream);
    case 1:
      return launch_windows<1>(wp, n_models, feats, sig, n_win, T, logits,
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
  switch (nr_stack_full_ring_slots(T)) {
    case 4:
      return launch_full<4>(wp, sig, feats, n_p, T, w_valid, n_windows,
                            logits, probs, stream);
    case 3:
      return launch_full<3>(wp, sig, feats, n_p, T, w_valid, n_windows,
                            logits, probs, stream);
    case 2:
      return launch_full<2>(wp, sig, feats, n_p, T, w_valid, n_windows,
                            logits, probs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
