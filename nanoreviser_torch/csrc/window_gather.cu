// Window gather for Hopper (sm_90a): compacted int16 signal -> normalized
// bf16 window rows.
//
// Replaces the TPU kernel _gather_kernel (nanoreviser_tpu/ops/
// window_gather.py:67). Per base row r and lane q < 50:
//   x = sig[clamp(pos0[r] + q, 0, S - 1)]
//   out[r, q] = bf16_rn((x - shift[rid]) / scale[rid])   if q in [left, left+vlen)
//             = 0                                         otherwise
// with left = (50 - vlen + 1) / 2 (floor), rid = read_id & 255, vlen & 63.
// Lanes 50..63 and rows at or past rows_valid are zero.
//
// What bounds it on this card: bytes. It does ~2 flops per output element
// and moves ~128 B of output per row plus the ~10 signal samples per row the
// windows overlap on; at 3.35 TB/s a 196,736-row batch is a few microseconds
// of traffic, so launch overhead and L2 latency of the overlapping 50-sample
// reads dominate. The design does the simplest thing that keeps traffic
// minimal: one thread per output element, consecutive threads on
// consecutive lanes of a row, so signal reads of a warp fall in one or two
// 128-byte lines and the bf16 stores coalesce into 128-byte rows. The TPU
// kernel's tricks (reversed signal, Toeplitz roll, one-hot MXU gather,
// 1024-aligned chunk DMA) exist for the TPU's tiled vector unit and are
// dropped.
//
// Exactness: this file must be compiled without --use_fast_math, so that '/'
// is IEEE div.rn.f32; the output is then bit-identical to the plain version
// and to the JAX package's window_gather_xla.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 50;   // window samples per base
constexpr int kQP = 64;  // padded output row width

__global__ void window_gather_kernel(const int16_t* __restrict__ sig, int s_cap,
                                     const int* __restrict__ pos0,
                                     const int* __restrict__ vlen,
                                     const int* __restrict__ read_id,
                                     const float* __restrict__ shift,
                                     const float* __restrict__ scale,
                                     int rows_valid, int n_rows,
                                     __nv_bfloat16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * kQP) return;
  const int row = idx / kQP;
  const int q = idx % kQP;
  float v = 0.0f;
  if (row < rows_valid && q < kQ) {
    const int vl = vlen[row] & 63;
    // floor((kQ - vl + 1) / 2); kQ - vl + 1 >= -12, so shift right by one
    // (arithmetic) is the floor division
    const int left = (kQ - vl + 1) >> 1;
    if (q >= left && q < left + vl) {
      const int rid = read_id[row] & 255;
      long long p = (long long)pos0[row] + q;
      p = p < 0 ? 0 : (p > s_cap - 1 ? s_cap - 1 : p);
      const float x = (float)sig[p];
      v = (x - shift[rid]) / scale[rid];
    }
  }
  out[idx] = __float2bfloat16_rn(v);
}

}  // namespace

extern "C" int nr_window_gather(const int16_t* sig, int s_cap, const int* pos0,
                                const int* vlen, const int* read_id,
                                const float* shift, const float* scale,
                                int rows_valid, int n_rows,
                                __nv_bfloat16* out, cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)n_rows * kQP;
  const int blocks = (int)((total + threads - 1) / threads);
  window_gather_kernel<<<blocks, threads, 0, stream>>>(
      sig, s_cap, pos0, vlen, read_id, shift, scale, rows_valid, n_rows, out);
  return (int)cudaGetLastError();
}
