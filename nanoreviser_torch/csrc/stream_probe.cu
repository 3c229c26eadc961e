// A probe of the weight stream that bounds the reviser stack's core
// (reviser_stack.cu): how fast can an SM fill per-warp rings of weight
// tiles in shared memory from L2, and how many bytes does the L2 then serve?
//
// Set-up as in stack_full at T = 11: one block of 8 warps per SM (the
// stack kernel's shared-memory footprint, passed as smem), each warp with
// its own ring of 8 KB in shared memory. Warp w streams its own 80 KB of a
// model's packed l3_r (layer 3's weights, 640 KB), `reps`
// times over, and acknowledges each 1 KB tile (each lane XORs the 32 bytes
// it would feed to its products into a register, stored at the end).
//
// Variants:
//   0  per-lane cp.async, as WeightStream in reviser_stack.cu: each lane
//      copies its 2 x 16 bytes of every tile, 7 tiles ahead in 8 slots;
//   1  one cp.async.bulk per fill of F bytes (F = 1 or 2 KB, 8 KB / F
//      slots), completing on mbarriers (namespace ring below, C = 1);
//   2  the same multicast over a cluster of C = 2, 4 or 8 CTAs: each CTA
//      copies 1/C of every fill into all C.
// Not a port of a TPU kernel: a measurement, run by chip_smoke.py's probe
// phase.

#include <cuda_runtime.h>
#include <stdint.h>

// Variants 1 and 2 run per-warp rings fed by TMA bulk copies (namespace
// ring). A ring holds S slots of F bytes, each with two mbarriers in shared
// memory: a full barrier (count 1: this CTA's producer lane arrives with
// expect_tx of the fill's bytes, and every byte that lands completes its
// transaction count) and an empty barrier (count C: warp w of each of the C
// CTAs of the cluster arrives once it has read the slot). Every CTA of a
// cluster runs the same sequence of fills through warp w's ring; for fill
// f (slot f % S), lane 0 of warp w in CTA r waits for the slot's empty
// barrier, then copies bytes [r B/C, (r+1) B/C) of the fill's B source
// bytes with one cp.async.bulk ... .multicast::cluster into that range of
// the slot in every CTA. So a byte read from L2 lands in C CTAs, and a CTA
// still receives every byte of every fill. `issued` and `taken` count the
// ring's fills, so the parity of each slot's barriers follows from them.
// Fills run at most S ahead of the slowest consumer of the cluster and all
// are consumed; the peers' last releases are fenced by a cluster barrier
// before any CTA exits.

namespace ring {

// A wait that has polled this often traps (a launch error) instead of
// hanging the card: a fill that never lands is a fault of the schedule.
constexpr uint32_t kSpinLimit = 1u << 26;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait for the completion of the barrier's phase of parity `parity`;
// kCluster: acquire at cluster scope (the arrivals came from peer CTAs)
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    if constexpr (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
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

// arrive on the barrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(bar), "r"(rank) : "memory");
}

// bytes (a multiple of 16, 16-byte aligned) from global memory into this
// CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the same into the same offset of the shared memory of every CTA in
// `mask`, each completing on its own barrier at `bar`'s offset
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar),
         "h"(mask)
      : "memory");
}

// Shared-memory bytes of the barriers of one warp's S-slot ring.
__host__ __device__ constexpr int barrier_bytes(int S) { return 16 * S; }

// One warp's ring (every lane holds the same copy). slot0: the ring's
// first slot (generic pointer into shared memory); bar0: the shared
// address of its S full barriers, then its S empty barriers.
template <int S, int F, int C>
struct Ring {
  static_assert(F % (16 * C) == 0, "a fill's shares must be 16-byte units");
  unsigned char* slot0;
  uint32_t bar0;
  uint32_t issued, taken;

  __device__ __forceinline__ void init(unsigned char* slots, uint32_t bars) {
    slot0 = slots;
    bar0 = bars;
    issued = 0;
    taken = 0;
  }

  // lane 0 of each warp, before the cluster's first cluster_sync
  __device__ __forceinline__ void init_barriers() const {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar0 + 8 * s, 1);
      mbar_init(bar0 + 8 * (S + s), C);
    }
  }

  // Fill `issued` from [src, src + bytes) (bytes <= F, a multiple of 16 C):
  // lane 0 waits until every CTA has released the slot's previous fill,
  // expects the bytes on its own full barrier and copies its share. All
  // lanes count it.
  __device__ __forceinline__ void issue(const void* src, uint32_t bytes) {
    if ((threadIdx.x & 31) == 0) {
      const uint32_t s = issued % S, k = issued / S;
      const uint32_t full = bar0 + 8 * s;
      if (k > 0) mbar_wait<C != 1>(bar0 + 8 * (S + s), (k - 1) & 1);
      mbar_expect_tx(full, bytes);
      const uint32_t dst = smem_addr(slot0 + (size_t)s * F);
      if constexpr (C == 1) {
        bulk_copy(dst, src, bytes, full);
      } else {
        const uint32_t share = bytes / C, off = share * cluster_rank();
        bulk_copy_multicast(dst + off,
                            static_cast<const unsigned char*>(src) + off,
                            share, full, (uint16_t)((1u << C) - 1));
      }
    }
    ++issued;
  }

  // all lanes: wait until fill `taken` has landed; returns its slot
  __device__ __forceinline__ const unsigned char* wait() const {
    mbar_wait<false>(bar0 + 8 * (taken % S), (taken / S) & 1);
    return slot0 + (size_t)(taken % S) * F;
  }

  // all lanes, once each has read what it needs of fill `taken`: release
  // its slot in every CTA of the cluster (lane j arrives on CTA j's)
  __device__ __forceinline__ void release() {
    __syncwarp();
    const uint32_t lane = threadIdx.x & 31, empty = bar0 + 8 * (S + taken % S);
    if constexpr (C == 1) {
      if (lane == 0) mbar_arrive(empty);
    } else {
      if (lane < C) mbar_arrive_peer(empty, lane);
    }
    ++taken;
  }
};

}  // namespace ring

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTile = 1024;               // bytes of one weight tile
constexpr int kRingBytes = 8 * kTile;     // per warp
constexpr int kRegion = 80 * kTile;       // per warp: 80 KB of l3_r

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(ring::smem_addr(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ uint32_t ack(const unsigned char* tile, int lane) {
  const uint4 lo = *reinterpret_cast<const uint4*>(tile + lane * 16);
  const uint4 hi = *reinterpret_cast<const uint4*>(tile + kTile / 2 + lane * 16);
  return lo.x ^ lo.y ^ lo.z ^ lo.w ^ hi.x ^ hi.y ^ hi.z ^ hi.w;
}

__global__ void __launch_bounds__(kThreads, 1)
probe_cp_async(const unsigned char* __restrict__ src, int reps, uint32_t* out) {
  constexpr int S = 8;
  extern __shared__ uint4 smem_u4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_u4) + warp * kRingBytes;
  const unsigned char* mine = src + (size_t)warp * kRegion;
  const int total = reps * (kRegion / kTile);
  int requested = 0;
  auto request = [&]() {
    if (requested < total) {
      const unsigned char* s = mine + (size_t)(requested % (kRegion / kTile)) * kTile;
      unsigned char* d = ring + (requested % S) * kTile;
      cp_async16(d + lane * 16, s + lane * 16);
      cp_async16(d + kTile / 2 + lane * 16, s + kTile / 2 + lane * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++requested;
  };
  for (int i = 0; i < S - 1; ++i) request();
  uint32_t acc = 0;
  for (int taken = 0; taken < total; ++taken) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(S - 2) : "memory");
    acc ^= ack(ring + (taken % S) * kTile, lane);
    request();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

template <int F, int C>
__global__ void __launch_bounds__(kThreads, 1)
probe_bulk(const unsigned char* __restrict__ src, int reps, uint32_t* out) {
  constexpr int S = kRingBytes / F;
  extern __shared__ uint4 smem_u4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_u4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ring::Ring<S, F, C> r;
  r.init(base + warp * kRingBytes,
         ring::smem_addr(base + kWarps * kRingBytes) +
             warp * ring::barrier_bytes(S));
  if (lane == 0) r.init_barriers();
  ring::fence_mbar_init();
  ring::cluster_sync();

  const unsigned char* mine = src + (size_t)warp * kRegion;
  constexpr int per_rep = kRegion / F;
  const int total = reps * per_rep;
  int next = 0;
  for (; next < S - 1 && next < total; ++next)
    r.issue(mine + (size_t)(next % per_rep) * F, F);
  uint32_t acc = 0;
  for (int taken = 0; taken < total; ++taken) {
    const unsigned char* slot = r.wait();
#pragma unroll
    for (int t = 0; t < F / kTile; ++t) acc ^= ack(slot + t * kTile, lane);
    r.release();
    if (next < total) {
      r.issue(mine + (size_t)(next % per_rep) * F, F);
      ++next;
    }
  }
  ring::cluster_sync();
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

template <typename K>
int launch(K kernel, int n_ctas, int cluster, size_t smem,
           const unsigned char* src, int reps, uint32_t* out,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, src, reps, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename K>
int active_clusters(K kernel, int cluster, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

template <int F>
int launch_bulk(int cluster, int n_ctas, size_t smem, const unsigned char* src,
                int reps, uint32_t* out, cudaStream_t stream) {
  switch (cluster) {
    case 1: return launch(probe_bulk<F, 1>, n_ctas, 1, smem, src, reps, out, stream);
    case 2: return launch(probe_bulk<F, 2>, n_ctas, 2, smem, src, reps, out, stream);
    case 4: return launch(probe_bulk<F, 4>, n_ctas, 4, smem, src, reps, out, stream);
    case 8: return launch(probe_bulk<F, 8>, n_ctas, 8, smem, src, reps, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of the source the probe reads: 8 warps x 80 tiles (one model's
// packed l3_r).
extern "C" int nr_probe_source_bytes() { return kWarps * kRegion; }

// Most clusters of `cluster` CTAs (1 block per SM at smem bytes) that can be
// resident at once, for the multicast variant's kernel (-1 on an error).
extern "C" int nr_probe_active_clusters(int cluster, int fill_bytes, int smem) {
  const bool big = fill_bytes == 2 * kTile;
  switch (cluster) {
    case 1: return big ? active_clusters(probe_bulk<2 * kTile, 1>, 1, smem)
                       : active_clusters(probe_bulk<kTile, 1>, 1, smem);
    case 2: return big ? active_clusters(probe_bulk<2 * kTile, 2>, 2, smem)
                       : active_clusters(probe_bulk<kTile, 2>, 2, smem);
    case 4: return big ? active_clusters(probe_bulk<2 * kTile, 4>, 4, smem)
                       : active_clusters(probe_bulk<kTile, 4>, 4, smem);
    case 8: return big ? active_clusters(probe_bulk<2 * kTile, 8>, 8, smem)
                       : active_clusters(probe_bulk<kTile, 8>, 8, smem);
    default: return -1;
  }
}

// variant 0: per-lane cp.async (cluster 1, fill_bytes 1024); 1: bulk copies
// (cluster 1); 2: multicast bulk copies over clusters of `cluster`.
// n_ctas (a multiple of cluster) blocks, smem bytes of dynamic shared memory
// each (>= the rings: 72 KB); out: n_ctas * 256 words.
extern "C" int nr_probe_stream(int variant, int cluster, int fill_bytes,
                               int n_ctas, int smem, const void* src, int reps,
                               uint32_t* out, cudaStream_t stream) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if (n_ctas < 1 || reps < 1 || n_ctas % cluster != 0 ||
      smem < kWarps * (kRingBytes + ring::barrier_bytes(8)))
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    if (cluster != 1 || fill_bytes != kTile) return (int)cudaErrorInvalidValue;
    return launch(probe_cp_async, n_ctas, 1, (size_t)smem, s, reps, out, stream);
  }
  if ((variant == 1) != (cluster == 1)) return (int)cudaErrorInvalidValue;
  if (fill_bytes == kTile)
    return launch_bulk<kTile>(cluster, n_ctas, (size_t)smem, s, reps, out, stream);
  if (fill_bytes == 2 * kTile)
    return launch_bulk<2 * kTile>(cluster, n_ctas, (size_t)smem, s, reps, out, stream);
  return (int)cudaErrorInvalidValue;
}
