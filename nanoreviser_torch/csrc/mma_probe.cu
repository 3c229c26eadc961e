// A probe of the products and the weight fills of the stack core's split
// layers (reviser_stack.cu), at layer 3's shape: one direction's 512 gate
// columns (H = 128) for 32 windows (16 own, 16 of the cluster's peer) over
// K = 20 k16 tiles (x 8, s 4, h 8), one block per SM at the stack kernel's
// shared memory. Not a port of a TPU kernel: a measurement, run by
// chip_smoke.py's probe phase.
//
// Products (operands already in shared memory, no stream): the weights
// hold kRes = 4 distinct k16 tiles (k tile kt reads tile kt % kRes), the
// activations all 20; every step zeroes its accumulators and runs one
// chain over the 20 k tiles, and the last step's sums are stored as
// out[block][gate column][window] (gate column g * 128 + unit).
//   probe_mma_sync   the split layers' mma.sync loop (reviser_stack.cu's
//                    gate_chain without its ring): 8 warps, each two
//                    groups of 8 units (2 m16 tiles of windows x 4 gates'
//                    n8 tiles), B fragments from the packed 1 KB tiles
//                    (two 16-byte reads a lane), A by ldmatrix.x4 from
//                    row-major activations;
//   probe_wgmma<N>   2 warpgroups of wgmma.mma_async with the weights as A
//                    (m64 tiles of 32 units x 2 gates, core-matrix layout
//                    from shared-memory descriptors) and the activations
//                    as B ([k/8][32 windows][8], core matrices of 8 rows x
//                    16 bytes): N = 32 one m64n32k16 per (m tile, k tile),
//                    N = 16 two m64n16k16 (own and peer windows) sharing A.
// Fills: probe_fill<F, R, kBulk>: one producer warp (warp 8) fills one ring
// of R bytes per block (slots of F bytes, full and empty mbarriers) from a
// 320 KB source (layer 3's weights of one step), either per lane with
// cp.async and cp.async.mbarrier.arrive.noinc, or with one cp.async.bulk
// per fill; the 8 consumer warps wait for each fill, XOR the 16-byte
// pieces they read and release the slot (one arrival a warp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kK = 20;                      // k16 tiles of the chain
constexpr int kRes = 4;                     // distinct k16 tiles of weights
constexpr int kWin = 32;                    // windows (16 own + 16 peer)
constexpr int kCols = 512;                  // gate columns of the block
constexpr int kLdA = kK * 16 + 8;           // probe_mma_sync's row stride
constexpr int kWBytes = kRes * kCols * 16 * 2;      // 64 KB of weights
constexpr int kXBytes = kWin * kLdA * 2;            // activations (<= 21 KB)
constexpr int kFillRingMax = 64 * 1024;             // probe_fill's largest ring
constexpr int kFillSource = 320 * 1024;             // probe_fill's source
constexpr uint32_t kSpinLimit = 1u << 26;   // a wait polled this often traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
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
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A B, A 64x16 and B 16x32 (bf16, from descriptors), d f32
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B, A 64x16 and B 16x16
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------- (a)

// w: [warp 8][group 2][kRes][2 halves][32 lanes][8] (the 1 KB tiles of
// pack_full_weights' gate layout), a: row-major [32][320] bf16
__global__ void __launch_bounds__(256, 1)
probe_mma_sync(const uint4* __restrict__ w, const uint4* __restrict__ a,
               int steps, float* __restrict__ out) {
  extern __shared__ uint4 smem[];
  bf16* W = reinterpret_cast<bf16*>(smem);
  bf16* X = W + kWBytes / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < kWBytes / 16; e += 256) smem[e] = w[e];
  for (int e = tid; e < kWin * kK * 2; e += 256)
    reinterpret_cast<uint4*>(X + (e / (kK * 2)) * kLdA)[e % (kK * 2)] = a[e];
  __syncthreads();
  const bf16* wl = W + (size_t)warp * 2 * kRes * 512 + lane * 8;
  const bf16* a0 = X + (lane & 15) * kLdA + (lane >> 4) * 8;
  const bf16* a1 = a0 + 16 * kLdA;
  float acc[2][2][4][4];
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][i][g][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < kK; ++kt) {
        uint32_t x0[4], x1[4], b[8];
        ldsm_x4(x0, a0 + kt * 16);
        ldsm_x4(x1, a1 + kt * 16);
        const bf16* p = wl + (q * kRes + kt % kRes) * 512;
        const uint4 lo = *reinterpret_cast<const uint4*>(p);
        const uint4 hi = *reinterpret_cast<const uint4*>(p + 256);
        b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
        b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          mma_bf16(acc[q][0][g], x0, b[2 * g], b[2 * g + 1]);
          mma_bf16(acc[q][1][g], x1, b[2 * g], b[2 * g + 1]);
        }
      }
    }
  }
  float* o = out + (size_t)blockIdx.x * kCols * kWin;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int unit = 8 * (2 * warp + q) + 2 * tq + (e & 1);
          const int win = 16 * i + gq + 8 * (e >> 1);
          o[(g * 128 + unit) * kWin + win] = acc[q][i][g][e];
        }
}

// ---------------------------------------------------------------- (b)

// w: [kRes][m tile 8][64 x 16 in core matrices: (k / 8) * 8 + row / 8,
// then row % 8, k % 8], x: [k / 8 (40)][32 windows][8]
template <int N>
__global__ void __launch_bounds__(256, 1)
probe_wgmma(const uint4* __restrict__ w, const uint4* __restrict__ x,
            int steps, float* __restrict__ out) {
  extern __shared__ uint4 smem[];
  bf16* W = reinterpret_cast<bf16*>(smem);
  bf16* X = W + kWBytes / 2;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  for (int e = tid; e < kWBytes / 16; e += 256) smem[e] = w[e];
  for (int e = tid; e < kWin * kK * 2; e += 256)
    reinterpret_cast<uint4*>(X)[e] = x[e];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t dw = smem_desc(W + (size_t)4 * wg * 1024, 1024, 128);
  const uint64_t dx = smem_desc(X, kWin * 16, 128);
  constexpr int R = N == 32 ? 16 : 8, H = N == 32 ? 1 : 2;
  float acc[4][H][R];
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h) {
#pragma unroll
        for (int e = 0; e < R; ++e) acc[i][h][e] = 0.0f;
        fence_regs(acc[i][h]);
      }
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kK; ++kt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint64_t da = dw + (((kt % kRes) * 8 + i) * 2048 >> 4);
        const uint64_t db = dx + (kt * 2 * kWin * 16 >> 4);
        if constexpr (N == 32) {
          wgmma_n32(acc[i][0], da, db);
        } else {
          wgmma_n16(acc[i][0], da, db);
          wgmma_n16(acc[i][1], da, db + (16 * 16 >> 4));
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h) fence_regs(acc[i][h]);
  }
  // accumulator e of n8 chunk j: row (lane / 4) + 8 (e / 2) of the warp's
  // 16, window 8 j + 2 (lane % 4) + e % 2; m tile mt = 2 ug + p holds gates
  // 2p (rows 0-7 of each 16) and 2p + 1 (rows 8-15) of units 32 ug + 8 warp
  // + row % 8
  float* o = out + (size_t)blockIdx.x * kCols * kWin;
  const int wq = (tid >> 5) & 3, r = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int e = 0; e < R; ++e) {
        const int mt = 4 * wg + i, j = e >> 2;
        const int gate = 2 * (mt & 1) + ((e >> 1) & 1);
        const int unit = 32 * (mt >> 1) + 8 * wq + r;
        const int win = 16 * h + 8 * j + 2 * cq + (e & 1);
        o[(gate * 128 + unit) * kWin + win] = acc[i][h][e];
      }
}

// ---------------------------------------------------------------- (d)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

template <int F, int R, bool kBulk>
__global__ void __launch_bounds__(288, 1)
probe_fill(const unsigned char* __restrict__ src, int reps, uint32_t* __restrict__ out) {
  constexpr int S = R / F, PER = kFillSource / F;
  extern __shared__ uint4 smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  const uint32_t bars = smem_u32(ring + R);           // S full, then S empty
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, kBulk ? 1 : 32);
      mbar_init(bars + 8 * (S + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = reps * PER;
  if (warp == 8) {   // the producer
    for (int f = 0; f < total; ++f) {
      const int s = f % S, k = f / S;
      const uint32_t full = bars + 8 * s;
      if (k > 0 && lane == 0) mbar_wait(bars + 8 * (S + s), (k - 1) & 1);
      __syncwarp();
      const unsigned char* from = src + (size_t)(f % PER) * F;
      unsigned char* to = ring + (size_t)s * F;
      if constexpr (kBulk) {
        if (lane == 0) {
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                       :: "r"(full), "r"(F) : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1], %2, [%3];\n"
              :: "r"(smem_u32(to)), "l"(__cvta_generic_to_global(from)), "r"(F),
                 "r"(full)
              : "memory");
        }
      } else {
#pragma unroll
        for (int j = 0; j < F / 512; ++j)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(smem_u32(to + j * 512 + lane * 16)),
                          "l"(__cvta_generic_to_global(from + j * 512 + lane * 16))
                       : "memory");
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(full) : "memory");
      }
    }
    if constexpr (!kBulk) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  uint32_t acc = 0;
  for (int f = 0; f < total; ++f) {
    const int s = f % S;
    mbar_wait(bars + 8 * s, (f / S) & 1);
    const unsigned char* slot = ring + (size_t)s * F;
#pragma unroll
    for (int j = 0; j < F / 4096; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(slot + j * 4096 + tid * 16);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + s));
  }
  out[(size_t)blockIdx.x * 256 + tid] = acc;
}

template <typename K>
int launch(K kernel, int threads, int n_ctas, size_t smem, cudaStream_t stream,
           const void* a, const void* b, int n, void* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_ctas, threads, smem, stream>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), n,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Products: variant 0 probe_mma_sync (w: 64 KB of 1 KB fragment tiles, a:
// row-major [32][320]), 1 probe_wgmma<16>, 2 probe_wgmma<32> (w: 64 KB of
// 2 KB m64 tiles, a: [40][32][8]); n_ctas blocks of smem bytes (>= 85 KB);
// out f32 [n_ctas][512][32].
extern "C" int nr_probe_mma(int variant, int n_ctas, int smem, const void* w,
                            const void* a, int steps, float* out,
                            cudaStream_t stream) {
  if (n_ctas < 1 || steps < 1 || smem < kWBytes + kXBytes)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return launch(probe_mma_sync, 256, n_ctas, smem, stream, w, a, steps, out);
    case 1: return launch(probe_wgmma<16>, 256, n_ctas, smem, stream, w, a, steps, out);
    case 2: return launch(probe_wgmma<32>, 256, n_ctas, smem, stream, w, a, steps, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of probe_fill's source (layer 3's weights of one direction's step).
extern "C" int nr_probe_fill_source_bytes() { return kFillSource; }

// Fills: variant 0 per-lane cp.async, 1 cp.async.bulk; (fill_bytes,
// ring_bytes) (8192 or 16384, 49152), (16384 or 32768, 65536); src
// kFillSource bytes (16-byte aligned); out uint32 [n_ctas][256]: consumer
// thread i's XOR of the words it read (odd reps: those of one pass over
// the source).
extern "C" int nr_probe_fill(int variant, int fill_bytes, int ring_bytes,
                             int n_ctas, int smem, const void* src, int reps,
                             uint32_t* out, cudaStream_t stream) {
  if (n_ctas < 1 || reps < 1 || smem < kFillRingMax + 2 * 8 * 8)
    return (int)cudaErrorInvalidValue;
  auto go = [&](void (*k)(const unsigned char*, int, uint32_t*)) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    k<<<n_ctas, 288, smem, stream>>>(static_cast<const unsigned char*>(src), reps, out);
    return (int)cudaGetLastError();
  };
  constexpr int k48 = 48 * 1024, k64 = 64 * 1024;
  if (ring_bytes == k48 && fill_bytes == 8192)
    return go(variant ? probe_fill<8192, k48, true> : probe_fill<8192, k48, false>);
  if (ring_bytes == k48 && fill_bytes == 16384)
    return go(variant ? probe_fill<16384, k48, true> : probe_fill<16384, k48, false>);
  if (ring_bytes == k64 && fill_bytes == 16384)
    return go(variant ? probe_fill<16384, k64, true> : probe_fill<16384, k64, false>);
  if (ring_bytes == k64 && fill_bytes == 32768)
    return go(variant ? probe_fill<32768, k64, true> : probe_fill<32768, k64, false>);
  return (int)cudaErrorInvalidValue;
}
