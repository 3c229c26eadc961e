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
// and moves 128 B of output per row plus ~10 int16 signal samples per row
// (neighbouring windows overlap): a 196,736-row batch is ~32 MB, 9.5 us at
// 3.35 TB/s. So the design is about the stores and the per-row work: one
// thread per 8 lanes of a row, which reads its row's scalars (pos0, vlen,
// read_id) once and at once, then its 8 samples and the read's shift and
// scale, and writes its 8 lanes as one 16-byte store; a warp writes 4 whole
// rows, 512 contiguous bytes. Pieces inside the signal buffer skip the
// per-sample clamp, pieces inside the window the per-lane test, so most
// threads do 8 loads, 8 divisions and one store. Lanes 48..55 hold the
// last two samples and six zeros, lanes 56..63 are zero without a load.
// The TPU kernel's
// tricks (reversed signal, Toeplitz roll, one-hot MXU gather, 1024-aligned
// chunk DMA) exist for the TPU's tiled vector unit and are dropped.
//
// Exactness: this file must be compiled without --use_fast_math, so that '/'
// is IEEE div.rn.f32; the output is then bit-identical to the plain version
// and to the JAX package's window_gather_xla.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 50;     // window samples per base
constexpr int kQP = 64;    // padded output row width
constexpr int kPiece = 8;  // lanes per thread: one 16-byte store
constexpr int kPieces = kQP / kPiece;

__global__ void window_gather_kernel(const int16_t* __restrict__ sig, int s_cap,
                                     const int* __restrict__ pos0,
                                     const int* __restrict__ vlen,
                                     const int* __restrict__ read_id,
                                     const float* __restrict__ shift,
                                     const float* __restrict__ scale,
                                     int rows_valid, int n_rows,
                                     __nv_bfloat16* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * kPieces) return;
  const int row = idx / kPieces;
  const int q0 = (idx % kPieces) * kPiece;
  uint32_t w[kPiece / 2] = {0u, 0u, 0u, 0u};   // bf16 pairs; +0.0 is 0
  if (row < rows_valid && q0 < kQ) {
    // the row's scalars, all at once; then the samples and the read's
    // normalizers, which depend only on them
    const int vr = __ldg(vlen + row), rr = __ldg(read_id + row);
    const int p = __ldg(pos0 + row);
    const float sh = __ldg(shift + (rr & 255)), sc = __ldg(scale + (rr & 255));
    float x[kPiece];
    if (p >= -q0 && p <= s_cap - kPiece - q0) {
      // samples p + q0 .. + 7 all inside the buffer: no clamp
      const int16_t* sp = sig + (p + q0);
#pragma unroll
      for (int j = 0; j < kPiece; ++j) x[j] = (float)__ldg(sp + j);
    } else {
#pragma unroll
      for (int j = 0; j < kPiece; ++j) {
        long long pj = (long long)p + q0 + j;
        pj = pj < 0 ? 0 : (pj > s_cap - 1 ? s_cap - 1 : pj);
        x[j] = (float)__ldg(sig + pj);
      }
    }
    const int vl = vr & 63;
    // floor((kQ - vl + 1) / 2); kQ - vl + 1 >= -12, so shift right by one
    // (arithmetic) is the floor division
    const int left = (kQ - vl + 1) >> 1;
    // the lanes of this piece inside [left, left + vl) and below kQ
    const int lo = max(left, q0);
    const int hi = min(min(left + vl, kQ), q0 + kPiece);
    float v[kPiece];
    if (lo == q0 && hi == q0 + kPiece) {
#pragma unroll
      for (int j = 0; j < kPiece; ++j) v[j] = (x[j] - sh) / sc;
    } else {
#pragma unroll
      for (int j = 0; j < kPiece; ++j)
        v[j] = q0 + j >= lo && q0 + j < hi ? (x[j] - sh) / sc : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPiece / 2; ++j) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
  *reinterpret_cast<uint4*>(out + (size_t)row * kQP + q0) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

extern "C" int nr_window_gather(const int16_t* sig, int s_cap, const int* pos0,
                                const int* vlen, const int* read_id,
                                const float* shift, const float* scale,
                                int rows_valid, int n_rows,
                                __nv_bfloat16* out, cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)n_rows * kPieces;
  const int blocks = (int)((total + threads - 1) / threads);
  window_gather_kernel<<<blocks, threads, 0, stream>>>(
      sig, s_cap, pos0, vlen, read_id, shift, scale, rows_valid, n_rows, out);
  return (int)cudaGetLastError();
}
