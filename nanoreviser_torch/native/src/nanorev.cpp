// Host-side per-read preparation for the serving path and the training
// labeller's banded aligner, in C++.
//
// The port's own copy of nanoreviser_tpu/native/src/nanorev.cpp (helpers
// :36-151, the banded aligner nr_banded_sw :162-255, nr_prep_read :280,
// nr_compact_read :382, the fast5 ingest nr_fast5_compact :405-787,
// nr_encode_wire :793-887). The ingest reads HDF5 with its own reader of
// the subset io/hdf5.py reads (see its section below), not with libhdf5,
// which the card's host does not have; zlib is loaded with dlopen, so the
// library builds from libc and libstdc++ alone.
//
// Every entry mirrors a function of the package bit for bit:
//   nr_prep_read     signal/host_prep.prep_read_numpy (inside each row's
//                    valid window span; the pad columns are zero here)
//   nr_compact_read  signal/host_prep.compact_read_numpy
//   nr_fast5_compact signal/host_prep.compact_read(io/fast5.get_read_data)
//   nr_encode_wire   infer/wire.encode_read
//   nr_banded_sw     align/sw.banded_sw_torch (ops, j_start and score equal;
//                    its f32 score arithmetic keeps the JAX scan's order)
//   nr_write_files   io/writers._write, for a burst of files (the bytes of
//                    open(path, "w").write(text), same mode and errno)
// All float math follows the numpy path operation for operation (f64
// divisions, one rounding from f64 to f16), so the library must be built
// with -ffp-contract=off: a fused multiply-add in s2/cnt - mean*mean would
// change the f64 values the features round from.
//
// ctypes releases the GIL for each call, so worker threads and processes
// scale these across cores.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>
#include <immintrin.h>

namespace {

// Exact double -> binary16 with a single rounding (numpy's f64 -> f16
// assignment). double -> float -> half would round twice and miss by 1 ulp
// near halfway points; rounding to odd at f32 first makes the final
// round-to-nearest exact (f32 keeps >= 2 extra bits over f16).
inline uint16_t f64_to_f16(double x) {
  float f = float(x);
  if (double(f) != x) {
    uint32_t b;
    std::memcpy(&b, &f, 4);
    if ((b & 1u) == 0) {  // inexact with an even last bit: take the other
      f = std::nextafterf(  // neighbour of x, whose last bit is odd
          f, (x > double(f)) ? HUGE_VALF : -HUGE_VALF);
    }
  }
  return _cvtss_sh(f, _MM_FROUND_TO_NEAREST_INT);
}

// Median of a histogram of n values: the mean of the two middle ranks
// (numpy's median), as a bin index.
double hist_median(const std::vector<int64_t>& h, int64_t n) {
  const int64_t lo_rank = (n - 1) / 2, hi_rank = n / 2;
  int64_t csum = 0, lo = -1, hi = -1;
  for (size_t b = 0; b < h.size(); ++b) {
    csum += h[b];
    if (lo < 0 && csum >= lo_rank + 1) lo = int64_t(b);
    if (csum >= hi_rank + 1) { hi = int64_t(b); break; }
  }
  return (double(lo) + double(hi)) / 2.0;
}

// Exact median and MAD of an int16 signal by histograms (numpy semantics;
// equal to signal/segmentation.mad_normalizers_int16 bit for bit).
void mad_core(const int16_t* tail, int64_t n_samples,
              double* shift_out, double* scale_out) {
  int16_t mn = tail[0], mx = tail[0];
  for (int64_t i = 1; i < n_samples; ++i) {
    mn = std::min(mn, tail[i]);
    mx = std::max(mx, tail[i]);
  }
  const int span = int(mx) - int(mn) + 1;
  std::vector<int64_t> hist(span, 0);
  for (int64_t i = 0; i < n_samples; ++i) hist[tail[i] - mn]++;
  const double shift = hist_median(hist, n_samples) + mn;
  // |x - shift| * 2 is an integer: histogram it exactly
  const int64_t two_shift = int64_t(std::llround(2.0 * shift));
  std::vector<int64_t> hist2(2 * size_t(span) + 2, 0);
  for (int64_t i = 0; i < n_samples; ++i) {
    int64_t d = 2 * (int64_t(tail[i]) - mn) - (two_shift - 2 * int64_t(mn));
    hist2[size_t(d < 0 ? -d : d)]++;
  }
  *shift_out = shift;
  *scale_out = hist_median(hist2, n_samples) * 0.5;
}

struct ColorTable {
  double v[256];
  ColorTable() {
    std::fill(v, v + 256, 0.0);
    v['A'] = 250.0; v['G'] = 180.0; v['T'] = 100.0; v['C'] = 30.0;
  }
};
const ColorTable kColor;

// Exact event moments of base i over [starts[i], next start) (the last base:
// its duration), clamped to the signal, and its 6 f16 feature columns
// [color/300, mean/shift, std/scale, duration/10, ab_mean, ab_std].
inline void base_features(const int16_t* tail, int64_t n_samples,
                          const int32_t* starts, int64_t n_bases, int64_t i,
                          const uint8_t* bases, const float* durations,
                          const float* ab_mean, const float* ab_std,
                          double shift, double scale, uint16_t* fr) {
  const int64_t st = starts[i];
  const int64_t en_raw =
      (i + 1 < n_bases) ? starts[i + 1] : st + int64_t(durations[i]);
  const int64_t en = std::min<int64_t>(en_raw, n_samples);
  int64_t s1 = 0, s2 = 0;
  for (int64_t j = st; j < en; ++j) {
    const int64_t v = tail[j];
    s1 += v;
    s2 += v * v;
  }
  const double cnt = double(std::max<int64_t>(en - st, 1));
  const double mean = double(s1) / cnt;
  const double var = std::max(double(s2) / cnt - mean * mean, 0.0);
  fr[0] = f64_to_f16(kColor.v[bases[i]] * (1.0 / 300.0));
  fr[1] = f64_to_f16(mean / shift);
  fr[2] = f64_to_f16(std::sqrt(var) / scale);
  fr[3] = f64_to_f16(double(durations[i]) * 0.1);
  fr[4] = _cvtss_sh(ab_mean[i], _MM_FROUND_TO_NEAREST_INT);
  fr[5] = _cvtss_sh(ab_std[i], _MM_FROUND_TO_NEAREST_INT);
}

// The compaction both nr_compact_read and nr_fast5_compact run.
int64_t compact_core(
    const int16_t* tail, int64_t n_samples,
    const int32_t* starts, int64_t n_bases,
    const uint8_t* bases,
    const float* durations,
    const float* ab_mean, const float* ab_std,
    int qlen,
    double* shift_io, double* scale_io,
    int16_t* csig_out, int64_t csig_cap,
    int32_t* pos0_out, uint8_t* vlen_out, uint16_t* feats_out) {
  if (n_samples < 1 || n_bases < 1 || qlen < 2 || qlen > 255) return -1;
  if (*shift_io <= -1e30) mad_core(tail, n_samples, shift_io, scale_io);
  const int ahead = qlen / 2;
  int64_t m = 0;          // compacted cursor
  int64_t src_hi = -1;    // source index of the compacted buffer's end
  int64_t ioff = 0;       // current interval: compacted - source offset
  for (int64_t i = 0; i < n_bases; ++i) {
    const int64_t st = starts[i];
    const int64_t w_st = std::max<int64_t>(st - ahead, 0);
    const int64_t w_en = std::min<int64_t>(st + (qlen - ahead), n_samples);
    const int64_t vl = std::max<int64_t>(w_en - w_st, 0);
    const int64_t left = (qlen - vl + 1) / 2;
    if (src_hi < 0 || w_st > src_hi) {       // start a new interval
      if (m + (w_en - w_st) > csig_cap) return -2;
      std::memcpy(csig_out + m, tail + w_st,
                  size_t(w_en - w_st) * sizeof(int16_t));
      ioff = m - w_st;
      m += w_en - w_st;
      src_hi = w_en;
    } else if (w_en > src_hi) {              // extend the current interval
      if (m + (w_en - src_hi) > csig_cap) return -2;
      std::memcpy(csig_out + m, tail + src_hi,
                  size_t(w_en - src_hi) * sizeof(int16_t));
      m += w_en - src_hi;
      src_hi = w_en;
    }
    pos0_out[i] = int32_t(w_st + ioff - left);
    vlen_out[i] = uint8_t(vl);
    base_features(tail, n_samples, starts, n_bases, i, bases, durations,
                  ab_mean, ab_std, *shift_io, *scale_io, feats_out + i * 6);
  }
  return m;
}

// The sample count compact_core writes for these starts (its intervals,
// without the copy).
int64_t compacted_len(const int32_t* starts, int64_t n_bases,
                      int64_t n_samples, int qlen) {
  const int ahead = qlen / 2;
  int64_t m = 0, src_hi = -1;
  for (int64_t i = 0; i < n_bases; ++i) {
    const int64_t w_st = std::max<int64_t>(int64_t(starts[i]) - ahead, 0);
    const int64_t w_en = std::min<int64_t>(int64_t(starts[i]) + (qlen - ahead),
                                           n_samples);
    if (src_hi < 0 || w_st > src_hi) {
      m += w_en - w_st;
      src_hi = w_en;
    } else if (w_en > src_hi) {
      m += w_en - src_hi;
      src_hi = w_en;
    }
  }
  return m;
}

// The duration feature f16(d * 0.1) for every pos0 row delta d in [0, 255].
struct DurTable {
  uint16_t v[256];
  DurTable() {
    for (int i = 0; i < 256; ++i) v[i] = f64_to_f16(double(i) * 0.1);
  }
};
const DurTable kDur;

// The aligner's score floor and 2-bit move codes (align/sw.py).
constexpr float NEG_INF = -1.0e9f;
constexpr int DIAG = 0, UP = 1, LEFT = 2;

// Band centre line of the aligner: the target column of row i,
// interpolated from t_lead across the read (align/sw.py _band_line).
inline int64_t j0_line(int64_t i, int64_t m, int64_t t_lead, int64_t span) {
    return t_lead + (span * i) / (m > 1 ? m : 1);
}

}  // namespace

extern "C" {

// Banded glocal alignment (read global, target local).
//   q, t     : base codes (A,C,G,T -> 0..3; anything else 4)
//   band     : band width (multiple of 4)
//   t_lead/t_tail : expected unaligned target overhangs (seed margins)
//   ops_out  : caller buffer of at least m + n bytes; moves in forward order
//   returns  : number of ops written, or -1 on error
int nr_banded_sw(
    const int8_t* q, int64_t m,
    const int8_t* t, int64_t n,
    int band, int64_t t_lead, int64_t t_tail,
    float match, float mismatch, float gap_open, float gap_extend,
    int8_t* ops_out, int64_t ops_cap,
    int64_t* j_start_out, float* score_out) {
    if (m < 1 || n < 1 || band < 4) return -1;

    const int half = band / 2;
    const int64_t span = std::max<int64_t>(n - t_lead - t_tail, 1);

    std::vector<float> h_prev(band), h_row(band), e_prev(band), e_row(band);
    std::vector<uint8_t> moves(static_cast<size_t>(m) * band, 0);

    // row 0: free leading target gap — H(0,j) = sub(q0, t_j)
    for (int k = 0; k < band; ++k) {
        int64_t j = j0_line(0, m, t_lead, span) + k - half;
        bool valid = j >= 0 && j < n;
        float sub = (valid && q[0] == t[j]) ? match : mismatch;
        h_prev[k] = valid ? sub : NEG_INF;
        e_prev[k] = NEG_INF;
    }

    for (int64_t i = 1; i < m; ++i) {
        const int64_t jc = j0_line(i, m, t_lead, span);
        const int64_t shift = jc - j0_line(i - 1, m, t_lead, span);
        uint8_t* mrow = moves.data() + static_cast<size_t>(i) * band;

        // in-row left-gap prefix max: run = max_{k'<=k} (h_nf(k') - k'*ext)
        float run = NEG_INF;
        for (int k = 0; k < band; ++k) {
            const int64_t sd = k + shift;
            const float h_diag =
                (sd - 1 >= 0 && sd - 1 < band) ? h_prev[sd - 1] : NEG_INF;
            const float h_up = (sd >= 0 && sd < band) ? h_prev[sd] : NEG_INF;
            const float e_up = (sd >= 0 && sd < band) ? e_prev[sd] : NEG_INF;

            const int64_t j = jc + k - half;
            const bool valid_j = j >= 0 && j < n;
            const float sub =
                (valid_j && q[i] == t[j]) ? match : mismatch;

            const float diag_score = h_diag + sub;
            const float e = std::max(h_up + gap_open, e_up + gap_extend);
            const float h_nf =
                valid_j ? std::max(diag_score, e) : NEG_INF;

            // f32 op order matches align/sw.py: (open + k*ext) + p_excl
            const float f = (gap_open + (float)k * gap_extend) + run;
            const float h = valid_j ? std::max(h_nf, f) : NEG_INF;

            run = std::max(run, h_nf - (float)k * gap_extend);

            h_row[k] = h;
            e_row[k] = e;
            mrow[k] = (h == diag_score) ? DIAG : ((h == e) ? UP : LEFT);
        }
        h_prev.swap(h_row);
        e_prev.swap(e_row);
    }

    // end column: first argmax on the true last row
    int k_end = 0;
    float best = h_prev[0];
    for (int k = 1; k < band; ++k) {
        if (h_prev[k] > best) { best = h_prev[k]; k_end = k; }
    }
    *score_out = best;

    // traceback (mirrors _traceback_host)
    std::vector<int8_t> rev;
    rev.reserve(m + 16);
    int64_t i = m - 1;
    int64_t j = j0_line(i, m, t_lead, span) + k_end - half;
    while (i > 0) {
        const int64_t k = j - j0_line(i, m, t_lead, span) + half;
        if (k < 0 || k >= band) {
            while (i > 0) { rev.push_back(DIAG); --i; --j; }
            break;
        }
        const int mv = moves[static_cast<size_t>(i) * band + k];
        if (mv == DIAG)      { rev.push_back(DIAG); --i; --j; }
        else if (mv == UP)   { rev.push_back(UP);   --i; }
        else                 { rev.push_back(LEFT); --j; }
    }
    rev.push_back(DIAG);  // row 0 consumes (q[0], t[j])

    const int64_t n_ops = static_cast<int64_t>(rev.size());
    if (n_ops > ops_cap) return -1;
    for (int64_t p = 0; p < n_ops; ++p) ops_out[p] = rev[n_ops - 1 - p];
    *j_start_out = j;
    return static_cast<int>(n_ops);
}

// Windowed prep of one read (prep_read_numpy).
//   tail      : int16 raw signal from read_start_rel_to_raw on          [S]
//   starts    : int32 base starts relative to the tail (monotone)       [N]
//   bases     : ascii base characters                                   [N]
//   durations : f32 per-base durations incl. the 3/5-rule tail          [N]
//   ab_mean/ab_std : f32 event-table moments                            [N]
//   shift/scale    : in: <= -1e30 means "compute here"; out: the values used
//   win_out   : int16 [N, qlen] window samples (columns outside the valid
//               span are zero; they are masked after normalization)
//   vlen_out  : u8 [N] valid window length
//   feats_out : u16 [N, 6] IEEE-754 binary16 bits
// Returns 0, or -1 on invalid input.
int nr_prep_read(
    const int16_t* tail, int64_t n_samples,
    const int32_t* starts, int64_t n_bases,
    const uint8_t* bases,
    const float* durations,
    const float* ab_mean, const float* ab_std,
    int qlen,
    double* shift_io, double* scale_io,
    int16_t* win_out, uint8_t* vlen_out, uint16_t* feats_out) {
  if (n_samples < 1 || n_bases < 1 || qlen < 2 || qlen > 255) return -1;
  if (*shift_io <= -1e30) mad_core(tail, n_samples, shift_io, scale_io);
  const int ahead = qlen / 2;
  for (int64_t i = 0; i < n_bases; ++i) {
    const int64_t st = starts[i];
    // window [st - ahead, st + qlen - ahead) clamped to the tail, placed
    // after the reference's left pad ceil((qlen - vlen) / 2)
    const int64_t w_st = std::max<int64_t>(st - ahead, 0);
    const int64_t w_en = std::min<int64_t>(st + (qlen - ahead), n_samples);
    const int64_t vl = std::max<int64_t>(w_en - w_st, 0);
    const int64_t left = (qlen - vl + 1) / 2;
    int16_t* row = win_out + i * qlen;
    std::memset(row, 0, size_t(qlen) * sizeof(int16_t));
    if (vl > 0) std::memcpy(row + left, tail + w_st, size_t(vl) * sizeof(int16_t));
    vlen_out[i] = uint8_t(vl);
    base_features(tail, n_samples, starts, n_bases, i, bases, durations,
                  ab_mean, ab_std, *shift_io, *scale_io, feats_out + i * 6);
  }
  return 0;
}

// Compacted prep of one read (compact_read_numpy): copies the union of the
// clamped window intervals into csig_out (gaps wider than a window, i.e.
// translocation stalls, are dropped), writes each base's gather start
// pos0 = (window start in csig) - left pad, its valid length and its
// features, as nr_prep_read does.
// Returns m (compacted sample count) >= 0, or -1 on invalid input, -2 if
// csig_cap is too small.
int64_t nr_compact_read(
    const int16_t* tail, int64_t n_samples,
    const int32_t* starts, int64_t n_bases,
    const uint8_t* bases,
    const float* durations,
    const float* ab_mean, const float* ab_std,
    int qlen,
    double* shift_io, double* scale_io,
    int16_t* csig_out, int64_t csig_cap,
    int32_t* pos0_out, uint8_t* vlen_out, uint16_t* feats_out) {
  return compact_core(tail, n_samples, starts, n_bases, bases, durations,
                      ab_mean, ab_std, qlen, shift_io, scale_io, csig_out,
                      csig_cap, pos0_out, vlen_out, feats_out);
}

// Wire-encode a compacted read (encode_read):
//   sig8      : zig-zag deltas, 255 = escape; sig8[0] is always 255
//   posd      : pos0 row deltas (posd[0] = 0 placeholder)
//   evf       : f16 bits of feats columns [1, 2, 4, 5]
//   codes     : 2-bit base code (A=0, G=1, T=2, C=3; else 0 + color escape)
//   dur esc   : rows where DUR_TABLE[pos delta] != feats[:, 3], plus the
//               last row (its delta comes from the next read in a batch)
// The escape lists are written in row order. Returns 0, or -1 on invalid
// input, -2 if an escape list is over its capacity, -6 if a pos0 delta is
// outside [0, 50].
int64_t nr_encode_wire(
    const int16_t* csig, int64_t m,
    const int32_t* pos0, const uint8_t* vlen,
    const uint16_t* feats /* [n, 6] f16 bits */, const uint8_t* bases,
    int64_t n,
    uint8_t* sig8, int32_t* sig_esc_idx, int32_t* sig_esc_delta,
    int64_t esc_cap,
    uint8_t* posd, uint16_t* evf /* [n, 4] */, uint8_t* codes,
    int32_t* dur_esc_idx, float* dur_esc_f32, int64_t dur_cap,
    int32_t* vlen_esc_idx, int32_t* vlen_esc_val, int64_t vl_cap,
    int32_t* col_esc_idx, int64_t col_cap,
    int64_t* counts_out /* [4]: ne, nd, nv, nc */) {
  if (m < 1 || n < 1) return -1;
  int8_t code_of[256];
  std::memset(code_of, -1, sizeof(code_of));
  code_of['A'] = 0; code_of['G'] = 1; code_of['T'] = 2; code_of['C'] = 3;

  int64_t ne = 0;
  sig8[0] = 255;
  for (int64_t i = 1; i < m; ++i) {
    const int32_t d = int32_t(csig[i]) - int32_t(csig[i - 1]);
    const uint32_t z = uint32_t((d << 1) ^ (d >> 31));
    if (z >= 255u) {
      if (ne >= esc_cap) return -2;
      sig8[i] = 255;
      sig_esc_idx[ne] = int32_t(i);
      sig_esc_delta[ne] = d;
      ++ne;
    } else {
      sig8[i] = uint8_t(z);
    }
  }

  int64_t nd = 0, nv = 0, nc = 0;
  posd[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t pd = 0;
    if (i + 1 < n) {
      pd = pos0[i + 1] - pos0[i];
      if (pd < 0 || pd > 50) return -6;
      posd[i + 1] = uint8_t(pd);
    }
    const uint16_t* fr = feats + i * 6;
    if (i + 1 == n || kDur.v[pd] != fr[3]) {
      if (nd >= dur_cap) return -2;
      dur_esc_idx[nd] = int32_t(i);
      dur_esc_f32[nd] = _cvtsh_ss(fr[3]);
      ++nd;
    }
    if (vlen[i] != 50) {
      if (nv >= vl_cap) return -2;
      vlen_esc_idx[nv] = int32_t(i);
      vlen_esc_val[nv] = int32_t(vlen[i]);
      ++nv;
    }
    const int8_t c = code_of[bases[i]];
    if (c < 0) {
      if (nc >= col_cap) return -2;
      col_esc_idx[nc] = int32_t(i);
      ++nc;
      codes[i] = 0;
    } else {
      codes[i] = uint8_t(c);
    }
    uint16_t* er = evf + i * 4;
    er[0] = fr[1]; er[1] = fr[2]; er[2] = fr[4]; er[3] = fr[5];
  }
  counts_out[0] = ne; counts_out[1] = nd;
  counts_out[2] = nv; counts_out[3] = nc;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native fast5 ingest: decode and compact one single-read fast5 in one call
// (nr_fast5_compact), the counterpart of the JAX package's nr_fast5_compact.
//
// The card's host has no libhdf5, so this section reads the HDF5 subset that
// io/hdf5.py reads, function by function (each h5:: function names its
// Python twin), and refuses what that reader refuses. Its result is what
// compact_read(get_read_data(path)) gives, bit for bit. Every offset and
// length is checked against the file's size, B-tree depth, B-tree nodes and
// object-header continuations are capped, and the file is mapped read-only.
//
// Deflate goes through zlib, loaded with dlopen("libz.so.1") at first use:
// a host may have zlib's runtime library without its header, and the rest
// of this library must build and run there. Without libz a compressed chunk
// returns its own code.

#include <dlfcn.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <deque>
#include <exception>
#include <map>
#include <string>

namespace {

// ---- zlib, declared by hand (zlib.h's z_stream on an LP64 host)
namespace zlib {

struct Stream {
  const uint8_t* next_in;
  unsigned avail_in;
  unsigned long total_in;
  uint8_t* next_out;
  unsigned avail_out;
  unsigned long total_out;
  const char* msg;
  void* state;
  void* zalloc;
  void* zfree;
  void* opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
};

struct Api {
  int (*init)(Stream*, const char*, int) = nullptr;   // inflateInit_
  int (*inflate)(Stream*, int) = nullptr;
  int (*end)(Stream*) = nullptr;
  bool ok = false;
};

const Api& api() {
  static const Api a = [] {
    Api r;
    void* h = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) return r;
    r.init = reinterpret_cast<int (*)(Stream*, const char*, int)>(
        dlsym(h, "inflateInit_"));
    r.inflate = reinterpret_cast<int (*)(Stream*, int)>(dlsym(h, "inflate"));
    r.end = reinterpret_cast<int (*)(Stream*)>(dlsym(h, "inflateEnd"));
    r.ok = r.init && r.inflate && r.end;
    return r;
  }();
  return a;
}

}  // namespace zlib

namespace h5 {

// return codes of nr_fast5_compact
constexpr int64_t E_INVALID = -1, E_CAPACITY = -2, E_READ = -3,
                  E_EVENTS = -4, E_SIGNAL = -5, E_SUBSET = -6, E_NO_ZLIB = -7;
constexpr uint64_t UNDEF = ~uint64_t(0);
constexpr int kMaxDepth = 32;                  // B-tree levels, nested types
constexpr uint64_t kMaxWork = uint64_t(1) << 22;  // nodes and messages a call visits
constexpr uint64_t kMaxBytes = uint64_t(1) << 28;  // one dataset or chunk, decoded

struct Fail {
  int64_t rc;
};
[[noreturn]] void bad() { throw Fail{E_READ}; }          // malformed
[[noreturn]] void unsupported() { throw Fail{E_SUBSET}; }  // outside the subset

inline uint64_t sat_add(uint64_t a, uint64_t b) {
  return a > UNDEF - b ? UNDEF : a + b;
}
inline uint64_t pad8(uint64_t n) { return sat_add(n, 7) / 8 * 8; }

struct Span {
  const uint8_t* p = nullptr;
  uint64_t n = 0;
};

// _Buf: a little-endian cursor; take() fails past the end, skip() does not
struct Buf {
  const uint8_t* data;
  uint64_t size;
  uint64_t pos;
  Buf(Span s, uint64_t at = 0) : data(s.p), size(s.n), pos(at) {}
  const uint8_t* take(uint64_t n) {
    if (pos > size || n > size - pos) bad();
    const uint8_t* p = data + pos;
    pos += n;
    return p;
  }
  Span take_span(uint64_t n) { return Span{take(n), n}; }
  uint64_t u(int n) {
    const uint8_t* p = take(uint64_t(n));
    uint64_t v = 0;
    for (int i = 0; i < n && i < 8; ++i) v |= uint64_t(p[i]) << (8 * i);
    return v;
  }
  void skip(uint64_t n) { pos = sat_add(pos, n); }
};

// Python's strict bytes.decode("utf-8")
bool utf8_ok(const uint8_t* s, uint64_t n) {
  uint64_t i = 0;
  while (i < n) {
    const uint8_t c = s[i];
    int len;
    uint32_t cp;
    if (c < 0x80) { ++i; continue; }
    if (c >= 0xC2 && c <= 0xDF) { len = 2; cp = c & 0x1F; }
    else if (c >= 0xE0 && c <= 0xEF) { len = 3; cp = c & 0x0F; }
    else if (c >= 0xF0 && c <= 0xF4) { len = 4; cp = c & 0x07; }
    else return false;
    if (n - i < uint64_t(len)) return false;
    for (int k = 1; k < len; ++k) {
      if ((s[i + k] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (s[i + k] & 0x3F);
    }
    if ((len == 3 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF))) ||
        (len == 4 && (cp < 0x10000 || cp > 0x10FFFF)))
      return false;
    i += len;
  }
  return true;
}

std::string text_of(Span s) {
  if (!utf8_ok(s.p, s.n)) bad();
  return std::string(reinterpret_cast<const char*>(s.p), s.n);
}

// ---- datatypes (_parse_datatype)
enum Cls { FIXED = 0, FLOAT = 1, STRING = 3, COMPOUND = 6, VLEN_STR = 9 };

struct Member;
struct DType {
  int cls = FIXED;
  uint64_t size = 0;        // numpy's itemsize (16 for a vlen string)
  bool is_signed = false;
  int charset = 0;          // vlen strings: 0 ASCII, 1 UTF-8
  std::vector<Member> members;
};
struct Member {
  std::string name;
  uint64_t off;
  DType t;
};

DType parse_datatype(Buf& b, int depth = 0) {
  if (depth > kMaxDepth) unsupported();
  const uint64_t head = b.u(1);
  const int cls = int(head & 0x0F), ver = int(head >> 4);
  const uint64_t bits = b.u(3);
  DType t;
  t.cls = cls;
  t.size = b.u(4);
  if (cls == FIXED) {
    if (bits & 1) unsupported();                 // big-endian
    b.skip(4);
    t.is_signed = bits & 0x08;
    if (t.size != 1 && t.size != 2 && t.size != 4 && t.size != 8) bad();
    return t;
  }
  if (cls == FLOAT) {
    if (bits & 1) unsupported();
    b.skip(12);
    if (t.size != 2 && t.size != 4 && t.size != 8 && t.size != 16) bad();
    return t;
  }
  if (cls == STRING) return t;
  if (cls == COMPOUND) {
    const uint64_t n_members = bits & 0xFFFF;
    for (uint64_t k = 0; k < n_members; ++k) {
      const uint64_t start = b.pos;
      if (start > b.size) bad();
      const void* z = std::memchr(b.data + start, 0, b.size - start);
      if (z == nullptr) bad();
      const uint64_t end = uint64_t(static_cast<const uint8_t*>(z) - b.data);
      Member m;
      m.name = text_of(Span{b.data + start, end - start});
      if (ver < 3) {
        b.pos = start + pad8(end - start + 1);
        m.off = b.u(4);
        if (ver == 1) b.skip(1 + 3 + 4 + 4 + 16);  // array dims of version 1
      } else {
        b.pos = end + 1;
        const int nb = t.size < 256 ? 1 : t.size < 65536 ? 2
                       : t.size < (uint64_t(1) << 24) ? 3 : 4;
        m.off = b.u(nb);
      }
      m.t = parse_datatype(b, depth + 1);
      t.members.push_back(std::move(m));
    }
    // numpy's checks of the dtype: no vlen member, unique names, every
    // field inside the itemsize
    for (size_t i = 0; i < t.members.size(); ++i) {
      const Member& m = t.members[i];
      if (m.t.cls == VLEN_STR) bad();
      if (m.t.size > t.size || m.off > t.size - m.t.size) bad();
      for (size_t j = 0; j < i; ++j)
        if (t.members[j].name == m.name) bad();
    }
    return t;
  }
  if (cls == 9) {
    parse_datatype(b, depth + 1);                // the base type
    if ((bits & 0x0F) != 1) unsupported();       // a sequence, not a string
    t.cls = VLEN_STR;
    t.charset = int((bits >> 8) & 0x0F);
    t.size = 16;
    return t;
  }
  unsupported();
}

// _parse_dataspace: the dims; a null dataspace is (0,)
std::vector<uint64_t> parse_dataspace(Buf& b) {
  const uint64_t ver = b.u(1), rank = b.u(1), flags = b.u(1);
  uint64_t kind;
  if (ver == 1) {
    b.skip(5);
    kind = rank ? 1 : 0;
  } else {
    kind = b.u(1);
  }
  std::vector<uint64_t> dims;
  for (uint64_t i = 0; i < rank; ++i) dims.push_back(b.u(8));
  if (flags & 1) b.skip(8 * rank);
  if (kind == 2) return {0};
  return dims;
}

// numpy's element count of a shape; () is one element
uint64_t count_of(const std::vector<uint64_t>& shape) {
  uint64_t c = 1;
  for (uint64_t d : shape) {
    if (d != 0 && c > kMaxBytes / d) unsupported();
    c *= d;
  }
  return c;
}

struct Msg {
  int type;
  Span body;
};

struct DatasetInfo {
  DType dtype;
  std::vector<uint64_t> shape;
  Span layout;
  std::vector<uint64_t> filters;           // filter ids, in pipeline order
};

struct Attr {
  DType dtype;
  std::vector<uint64_t> shape;
  Span raw;
  std::string vlen0;        // a vlen string attribute's first value
};

// _Reader over a read-only mapping of the file
class Reader {
 public:
  explicit Reader(const char* path) {
    const int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) bad();
    struct stat st;
    if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode) || st.st_size < 8) {
      close(fd);
      bad();
    }
    void* p = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_PRIVATE | MAP_POPULATE, fd, 0);
    close(fd);
    if (p == MAP_FAILED) bad();
    map_ = p;
    file_ = Span{static_cast<const uint8_t*>(p), uint64_t(st.st_size)};
    superblock();
  }
  ~Reader() {
    if (map_ != nullptr) munmap(map_, size_t(file_.n));
  }
  Reader(const Reader&) = delete;
  Reader& operator=(const Reader&) = delete;

  uint64_t root() const { return root_; }

  // messages / _messages_v2: [(type, body)] of one object header
  std::vector<Msg> messages(uint64_t addr) {
    if (addr < file_.n && file_.n - addr >= 4 &&
        std::memcmp(file_.p + addr, "OHDR", 4) == 0)
      return messages_v2(addr);
    Buf b(file_, addr);
    if (b.u(1) != 1) bad();
    b.skip(1);
    const uint64_t n_msgs = b.u(2);
    b.skip(4);
    const uint64_t size = b.u(4);
    std::deque<std::pair<uint64_t, uint64_t>> blocks{{sat_add(addr, 16), size}};
    std::vector<Msg> out;
    while (!blocks.empty() && out.size() < n_msgs) {
      const auto [start, length] = blocks.front();
      blocks.pop_front();
      Buf c(file_, start);
      while (c.pos < sat_add(start, length) && out.size() < n_msgs) {
        work();
        const int mtype = int(c.u(2));
        const uint64_t msize = c.u(2);
        c.skip(4);
        const Span body = c.take_span(msize);
        if (mtype == 0x10) {
          Buf k(body);
          const uint64_t caddr = k.u(8);
          blocks.emplace_back(caddr, k.u(8));
        }
        out.push_back(Msg{mtype, body});
      }
    }
    return out;
  }

  // links: name -> object header address, in name order
  std::map<std::string, uint64_t> links(uint64_t addr) {
    std::map<std::string, uint64_t> out;
    for (const Msg& m : messages(addr)) {
      if (m.type == 0x11) {                     // symbol table
        Buf b(m.body);
        const uint64_t btree = b.u(8), heap = b.u(8);
        const Span names = local_heap(heap);
        btree_group(btree, 0, [&](uint64_t name_off, uint64_t obj) {
          if (name_off > names.n) bad();
          const void* z = std::memchr(names.p + name_off, 0, names.n - name_off);
          if (z == nullptr) bad();
          const uint64_t end = uint64_t(static_cast<const uint8_t*>(z) - names.p);
          out[text_of(Span{names.p + name_off, end - name_off})] = obj;
        });
      } else if (m.type == 0x06) {              // link (compact storage)
        Buf b(m.body);
        b.skip(1);
        const uint64_t flags = b.u(1);
        const uint64_t ltype = (flags & 0x08) ? b.u(1) : 0;
        if (flags & 0x04) b.skip(8);
        if (flags & 0x10) b.skip(1);
        const uint64_t nlen = b.u(1 << (flags & 3));
        std::string name = text_of(b.take_span(nlen));
        if (ltype == 0) out[name] = b.u(8);
      } else if (m.type == 0x02) {              // link info
        Buf b(m.body);
        b.skip(1);
        if (b.u(1) & 1) b.skip(8);
        if (b.u(8) != UNDEF) unsupported();     // dense link storage
      }
    }
    return out;
  }

  bool is_group(uint64_t addr) {
    for (const Msg& m : messages(addr))
      if (m.type == 0x11 || m.type == 0x02 || m.type == 0x06) return true;
    return false;
  }

  // dataset: dtype, shape, layout and filters of a dataset object header
  DatasetInfo dataset(uint64_t addr) {
    DatasetInfo d;
    bool has_type = false, has_shape = false, has_layout = false;
    for (const Msg& m : messages(addr)) {
      Buf b(m.body);
      if (m.type == 0x01) {
        d.shape = parse_dataspace(b);
        has_shape = true;
      } else if (m.type == 0x03) {
        d.dtype = parse_datatype(b);
        has_type = true;
      } else if (m.type == 0x08) {
        d.layout = m.body;
        has_layout = true;
      } else if (m.type == 0x0B) {
        d.filters = filters(b);
      }
    }
    if (!has_type || !has_shape || !has_layout) bad();
    return d;
  }

  // _raw: the dataset's bytes (a view of the mapping where it is contiguous)
  Span raw(const DatasetInfo& d, std::vector<uint8_t>* store) {
    Buf b(d.layout);
    const uint64_t ver = b.u(1), cls = b.u(1);
    if ((ver != 3 && ver != 4) || (ver == 4 && cls == 2)) unsupported();
    const uint64_t count = count_of(d.shape);
    const uint64_t itemsize = d.dtype.size;
    if (itemsize != 0 && count > kMaxBytes / itemsize) unsupported();
    const uint64_t nbytes = count * itemsize;
    if (cls == 0) {                              // compact
      const Span s = b.take_span(b.u(2));
      return Span{s.p, std::min(s.n, nbytes)};
    }
    if (cls == 1) {                              // contiguous
      const uint64_t addr = b.u(8);
      if (addr == UNDEF) {
        store->assign(nbytes, 0);
        return Span{store->data(), nbytes};
      }
      if (addr > file_.n || nbytes > file_.n - addr) bad();
      return Span{file_.p + addr, nbytes};
    }
    if (cls == 2) {                              // chunked
      const uint64_t rank = b.u(1) - 1;
      const uint64_t btree = b.u(8);
      if (rank != 1 || d.shape.size() != 1) unsupported();
      const uint64_t chunk = b.u(4);
      chunked(btree, chunk, d, nbytes, store);
      return Span{store->data(), nbytes};
    }
    unsupported();
  }

  // attrs: every attribute message's name, type, shape and value bytes;
  // each value is read as read_value reads it (a later name wins)
  std::map<std::string, Attr> attrs(uint64_t addr) {
    std::map<std::string, Attr> out;
    for (const Msg& m : messages(addr)) {
      if (m.type != 0x0C) continue;
      Buf b(m.body);
      const uint64_t ver = b.u(1);
      b.skip(1);
      const uint64_t nsize = b.u(2), tsize = b.u(2), ssize = b.u(2);
      if (ver >= 3) b.skip(1);
      auto pad = [ver](uint64_t n) { return ver == 1 ? pad8(n) : n; };
      const Span nm = b.take_span(pad(nsize));
      std::string name = text_of(Span{nm.p, nsize ? std::min(nsize - 1, nm.n) : 0});
      Attr a;
      const uint64_t t0 = b.pos;
      a.dtype = parse_datatype(b);
      b.pos = sat_add(t0, pad(tsize));
      const uint64_t s0 = b.pos;
      a.shape = parse_dataspace(b);
      b.pos = sat_add(s0, pad(ssize));
      a.raw = b.pos <= m.body.n ? Span{m.body.p + b.pos, m.body.n - b.pos}
                                : Span{m.body.p, 0};
      read_value(&a);
      out[name] = std::move(a);
    }
    return out;
  }

 private:
  void work() {
    if (++work_ > kMaxWork) unsupported();
  }

  // _Reader.__init__: superblock v0-3 with 8-byte offsets and lengths
  void superblock() {
    static const uint8_t kSig[8] = {0x89, 'H', 'D', 'F', '\r', '\n', 0x1a, '\n'};
    if (std::memcmp(file_.p, kSig, 8) != 0) bad();
    Buf b(file_, 8);
    const uint64_t ver = b.u(1);
    if (ver == 0 || ver == 1) {
      b.skip(4);
      if (b.u(1) != 8 || b.u(1) != 8) unsupported();
      b.skip(1 + 4 + 4 + (ver == 1 ? 4 : 0));
      b.skip(8 * 4);                             // base, free space, eof, driver
      b.skip(8);                                 // root link name offset
      root_ = b.u(8);
    } else if (ver == 2 || ver == 3) {
      if (b.u(1) != 8 || b.u(1) != 8) unsupported();
      b.skip(1 + 8 * 3);
      root_ = b.u(8);
    } else {
      unsupported();
    }
  }

  std::vector<Msg> messages_v2(uint64_t addr) {
    Buf b(file_, sat_add(addr, 4));
    b.skip(1);                                   // version 2
    const uint64_t flags = b.u(1);
    if (flags & 0x20) b.skip(16);                // times
    if (flags & 0x10) b.skip(4);                 // attribute phase change
    const uint64_t size = b.u(1 << (flags & 3));
    const bool tracked = flags & 0x04;
    std::vector<Msg> out;
    // (start, length) in signed 128-bit: a continuation's clen - 8 may be
    // negative, as the Python ints are
    std::deque<std::pair<__int128, __int128>> blocks{{__int128(b.pos), __int128(size)}};
    int n_blocks = 0;
    while (!blocks.empty()) {
      if (++n_blocks > 1024) unsupported();
      const auto [start, length] = blocks.front();
      blocks.pop_front();
      if (start > __int128(UNDEF)) bad();
      Buf c(file_, uint64_t(start));
      while (__int128(c.pos) + 4 <= start + length) {
        work();
        const int mtype = int(c.u(1));
        const uint64_t msize = c.u(2);
        c.skip(1 + (tracked ? 2 : 0));
        const Span body = c.take_span(msize);
        if (mtype == 0x10) {
          Buf k(body);
          const uint64_t caddr = k.u(8), clen = k.u(8);
          blocks.emplace_back(__int128(caddr) + 4, __int128(clen) - 8);
        }
        out.push_back(Msg{mtype, body});
      }
    }
    return out;
  }

  // _local_heap: the heap's data segment (clamped to the file, like a slice)
  Span local_heap(uint64_t addr) {
    Buf b(file_, addr);
    if (std::memcmp(b.take(4), "HEAP", 4) != 0) bad();
    b.skip(4);
    const uint64_t size = b.u(8);
    b.skip(8);
    const uint64_t start = b.u(8);
    if (start >= file_.n) return Span{file_.p, 0};
    return Span{file_.p + start, std::min(size, file_.n - start)};
  }

  // _btree_group: (name offset, object address) of every symbol-table entry
  template <class F>
  void btree_group(uint64_t addr, int depth, F&& visit) {
    if (depth > kMaxDepth) unsupported();
    work();
    Buf b(file_, addr);
    if (std::memcmp(b.take(4), "TREE", 4) != 0) bad();
    b.u(1);
    const uint64_t level = b.u(1), used = b.u(2);
    b.skip(16);
    std::vector<uint64_t> children;
    for (uint64_t i = 0; i < used; ++i) {
      b.skip(8);                                 // key
      children.push_back(b.u(8));
    }
    for (uint64_t child : children) {
      if (level > 0) {
        btree_group(child, depth + 1, visit);
        continue;
      }
      work();
      Buf s(file_, child);
      if (std::memcmp(s.take(4), "SNOD", 4) != 0) bad();
      s.skip(2);
      const uint64_t n = s.u(2);
      for (uint64_t i = 0; i < n; ++i) {
        const uint64_t name_off = s.u(8), obj = s.u(8);
        s.skip(24);
        visit(name_off, obj);
      }
    }
  }

  // _filters: the pipeline's filter ids, in order
  std::vector<uint64_t> filters(Buf& b) {
    const uint64_t ver = b.u(1), n = b.u(1);
    if (ver == 1) b.skip(6);
    std::vector<uint64_t> out;
    for (uint64_t i = 0; i < n; ++i) {
      const uint64_t fid = b.u(2);
      const uint64_t nlen = (ver == 1 || fid >= 256) ? b.u(2) : 0;
      b.skip(2);                                 // flags
      const uint64_t nvals = b.u(2);
      if (nlen) b.skip(ver == 1 ? pad8(nlen) : nlen);
      for (uint64_t k = 0; k < nvals; ++k) b.u(4);
      if (ver == 1 && nvals % 2) b.skip(4);
      out.push_back(fid);
    }
    return out;
  }

  // _chunked (1-D): chunks in B-tree order into zeros; a missing chunk
  // stays zero
  void chunked(uint64_t btree, uint64_t chunk, const DatasetInfo& d,
               uint64_t nbytes, std::vector<uint8_t>* out) {
    out->assign(nbytes, 0);
    if (btree == UNDEF) return;
    const uint64_t itemsize = d.dtype.size, shape = d.shape[0];
    if (chunk == 0) unsupported();
    std::vector<uint8_t> buf, tmp;
    btree_chunks(btree, 0, [&](uint64_t off, uint64_t mask, uint64_t addr,
                               uint64_t size) {
      Span raw = addr >= file_.n ? Span{file_.p, 0}
                                 : Span{file_.p + addr, std::min(size, file_.n - addr)};
      for (auto f = d.filters.rbegin(); f != d.filters.rend(); ++f) {
        if (mask) unsupported();                 // partially filtered chunk
        if (*f == 1) {
          inflate(raw, chunk * itemsize, &tmp);
          buf.swap(tmp);
        } else if (*f == 2) {
          if (itemsize == 0 || raw.n % itemsize) bad();
          tmp.resize(raw.n);
          unshuffle(raw.p, raw.n / itemsize, itemsize, tmp.data());
          buf.swap(tmp);
        } else {
          unsupported();
        }
        raw = Span{buf.data(), buf.size()};
      }
      if (itemsize == 0 || chunk > raw.n / itemsize) bad();  // frombuffer
      if (off < shape) {
        const uint64_t stop = chunk > shape - off ? shape : off + chunk;
        std::memcpy(out->data() + off * itemsize, raw.p, (stop - off) * itemsize);
      } else if (off > shape && chunk > off - shape + 1) {
        bad();    // numpy cannot broadcast the chunk's tail into nothing
      }
    });
  }

  template <class F>
  void btree_chunks(uint64_t addr, int depth, F&& visit) {
    if (depth > kMaxDepth) unsupported();
    work();
    Buf b(file_, addr);
    if (std::memcmp(b.take(4), "TREE", 4) != 0) bad();
    b.u(1);
    const uint64_t level = b.u(1), used = b.u(2);
    b.skip(16);
    for (uint64_t i = 0; i < used; ++i) {
      const uint64_t size = b.u(4), mask = b.u(4);
      const uint64_t off = b.u(8);
      b.u(8);                                    // the element dimension
      const uint64_t child = b.u(8);
      if (level > 0)
        btree_chunks(child, depth + 1, visit);
      else
        visit(off, mask, child, size);
    }
  }

  // The shuffle filter's inverse: byte k of item i is at src[k * n + i].
  // Rows are done in blocks so the block's output stays in L1.
  static void unshuffle(const uint8_t* src, uint64_t n, uint64_t item,
                        uint8_t* dst) {
    if (item == 2) {
      for (uint64_t i = 0; i < n; ++i) {
        dst[2 * i] = src[i];
        dst[2 * i + 1] = src[n + i];
      }
      return;
    }
    constexpr uint64_t kBlock = 64;
    for (uint64_t i0 = 0; i0 < n; i0 += kBlock) {
      const uint64_t i1 = std::min(n, i0 + kBlock);
      for (uint64_t k = 0; k < item; ++k) {
        const uint8_t* s = src + k * n;
        for (uint64_t i = i0; i < i1; ++i) dst[i * item + k] = s[i];
      }
    }
  }

  // zlib.decompress: inflate the whole stream (trailing bytes ignored)
  static void inflate(Span in, uint64_t hint, std::vector<uint8_t>* out) {
    const zlib::Api& z = zlib::api();
    if (!z.ok) throw Fail{E_NO_ZLIB};
    if (in.n > 0xFFFFFFFFu) unsupported();
    zlib::Stream s{};
    if (z.init(&s, "1.2.11", int(sizeof(s))) != 0) throw Fail{E_NO_ZLIB};
    struct End {
      const zlib::Api& z;
      zlib::Stream* s;
      ~End() { z.end(s); }
    } end{z, &s};
    s.next_in = in.p;
    s.avail_in = unsigned(in.n);
    out->resize(std::max<uint64_t>(std::min(hint, kMaxBytes), 64));
    for (;;) {
      const uint64_t done = s.total_out;
      if (done == out->size()) {
        if (out->size() >= kMaxBytes) unsupported();
        out->resize(std::min<uint64_t>(2 * out->size(), kMaxBytes));
      }
      s.next_out = out->data() + done;
      s.avail_out = unsigned(std::min<uint64_t>(out->size() - done, 0xFFFFFFFFu));
      const int rc = z.inflate(&s, 0);
      if (rc == 1) break;                        // Z_STREAM_END
      if (rc != 0 && !(rc == -5 && s.avail_out == 0)) bad();
      if (rc == 0 && s.avail_in == 0 && s.avail_out != 0) bad();  // truncated
    }
    out->resize(s.total_out);
  }

  // read_value's checks: enough bytes for the count of items, and each vlen
  // string found in its global heap (and valid UTF-8 where it says so)
  void read_value(Attr* a) {
    const uint64_t count = count_of(a->shape);
    if (a->dtype.cls == VLEN_STR) {
      Buf r(a->raw);
      for (uint64_t i = 0; i < count; ++i) {
        const uint64_t length = r.u(4), gaddr = r.u(8), idx = r.u(4);
        Span s = global_heap(gaddr, idx);
        s.n = std::min(s.n, length);
        if (a->dtype.charset == 1 && !utf8_ok(s.p, s.n)) bad();
        if (i == 0) a->vlen0.assign(reinterpret_cast<const char*>(s.p), s.n);
      }
      return;
    }
    const uint64_t itemsize = a->dtype.size;
    if (itemsize == 0 || count > a->raw.n / itemsize) bad();
  }

  // _global_heap: object ``index`` of the collection at ``addr``
  Span global_heap(uint64_t addr, uint64_t index) {
    Buf b(file_, addr);
    if (std::memcmp(b.take(4), "GCOL", 4) != 0) bad();
    b.skip(4);
    const uint64_t end = sat_add(addr, b.u(8));
    while (sat_add(b.pos, 16) <= end) {
      work();
      const uint64_t idx = b.u(2);
      b.skip(6);
      const uint64_t size = b.u(8);
      if (idx == 0) break;
      if (idx == index) return b.take_span(size);
      b.skip(pad8(size));
    }
    bad();
  }

  void* map_ = nullptr;
  Span file_;
  uint64_t root_ = 0;
  uint64_t work_ = 0;
};

// Group.__getitem__: walk a path from the root; every node on it is opened
// as h5py-like code opens it (a group, or a dataset whose header parses)
struct Node {
  uint64_t addr;
  bool group;
  DatasetInfo ds;
};

Node walk(Reader& r, const std::string& path) {
  Node node{r.root(), true, {}};
  size_t i = 0;
  while (i <= path.size()) {
    size_t j = path.find('/', i);
    if (j == std::string::npos) j = path.size();
    const std::string part = path.substr(i, j - i);
    i = j + 1;
    if (part.empty()) continue;
    if (!node.group) bad();
    const auto links = r.links(node.addr);
    const auto it = links.find(part);
    if (it == links.end()) bad();
    node.addr = it->second;
    node.group = r.is_group(node.addr);
    if (!node.group) node.ds = r.dataset(node.addr);
  }
  return node;
}

// io/fast5._version_leq_zero on the attribute's text
bool version_leq_zero(const std::string& text) {
  size_t n_parts = 0;
  bool all_zero = true;
  size_t i = 0;
  for (;;) {                                     // text.split(".")
    size_t j = text.find('.', i);
    if (j == std::string::npos) j = text.size();
    size_t k = i;
    while (k < j && text[k] >= '0' && text[k] <= '9') {
      all_zero &= text[k] == '0';
      ++k;
    }
    if (k == i) break;                           // a token with no digit
    ++n_parts;
    if (j == text.size()) break;
    i = j + 1;
  }
  return n_parts == 0 || all_zero;
}

// Whether a present ``version`` attribute says legacy; a value that is not a
// scalar string (or not ASCII) is left to the Python path.
bool version_attr_legacy(const Attr& a) {
  if (!a.shape.empty()) unsupported();
  std::string text;
  if (a.dtype.cls == STRING) {
    if (a.dtype.size > a.raw.n) bad();
    uint64_t n = a.dtype.size;                   // numpy strips trailing NULs
    while (n > 0 && a.raw.p[n - 1] == 0) --n;
    text.assign(reinterpret_cast<const char*>(a.raw.p), n);
  } else if (a.dtype.cls == VLEN_STR) {
    text = a.vlen0;
  } else {
    unsupported();
  }
  if (!utf8_ok(reinterpret_cast<const uint8_t*>(text.data()), text.size())) bad();
  for (unsigned char c : text)
    if (c >= 0x80) unsupported();
  return version_leq_zero(text);
}

inline float half_to_float(const uint8_t* p) {
  uint16_t h;
  std::memcpy(&h, p, 2);
  return _cvtsh_ss(h);
}

template <class T>
inline T load(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

// One stored number converted as numpy's astype converts it (C casts).
template <class Out>
Out convert(const uint8_t* p, const DType& t) {
  if (t.cls == FIXED) {
    switch (t.size) {
      case 1: return t.is_signed ? Out(load<int8_t>(p)) : Out(load<uint8_t>(p));
      case 2: return t.is_signed ? Out(load<int16_t>(p)) : Out(load<uint16_t>(p));
      case 4: return t.is_signed ? Out(load<int32_t>(p)) : Out(load<uint32_t>(p));
      default: return t.is_signed ? Out(load<int64_t>(p)) : Out(load<uint64_t>(p));
    }
  }
  switch (t.size) {
    case 2: return Out(half_to_float(p));
    case 4: return Out(load<float>(p));
    default: return Out(load<double>(p));
  }
}

// ``value == v`` in the stored type
bool equals(const uint8_t* p, const DType& t, int v) {
  if (t.cls == FIXED) {
    if (t.is_signed) return convert<int64_t>(p, t) == v;
    return convert<uint64_t>(p, t) == uint64_t(v);
  }
  return convert<double>(p, t) == double(v);
}

bool is_number(const DType& t) {
  return t.cls == FIXED || (t.cls == FLOAT && t.size != 16);
}

// numpy's float -> int64 cast on x86-64 (out of range or NaN: INT64_MIN)
inline int64_t f64_to_i64(double x) {
  return (x >= -9223372036854775808.0 && x < 9223372036854775808.0)
             ? int64_t(x) : INT64_MIN;
}

// numpy's cast of a stored signal sample to int16: integers wrap, floats go
// through int32 (out of range or NaN: INT32_MIN)
inline int16_t to_i16(const uint8_t* p, const DType& t) {
  if (t.cls == FIXED) return int16_t(convert<uint64_t>(p, t));
  const double x = convert<double>(p, t);
  const int32_t v = (x > -2147483649.0 && x < 2147483648.0) ? int32_t(x) : INT32_MIN;
  return int16_t(v);
}

const Member* member(const DType& t, const char* name) {
  for (const Member& m : t.members)
    if (m.name == name) return &m;
  bad();                                         // KeyError
}

}  // namespace h5

}  // namespace

extern "C" {

// Whether libz could be loaded (compressed datasets need it).
int nr_zlib_loaded() { return zlib::api().ok ? 1 : 0; }

// Decode and compact one single-read fast5 (io/fast5.get_read_data, then
// nr_compact_read on its arrays):
//   group/subgroup : the basecall group and subgroup names
//   bases_out      : ascii bases, capacity bases_cap (also the capacity of
//                    pos0_out, vlen_out and feats_out rows)
//   csig_out       : compacted signal, capacity csig_cap
//   counts_out     : [2] bases and compacted samples; set on success and
//                    on -2, so the caller can allocate once
// Returns the number of bases (>= 2), or
//   -1 the decoded arrays are refused by the compaction (as nr_compact_read
//      would refuse them)             -2 an output capacity is too small
//   -3 open / malformed file          -4 events too short or all zero moves
//   -5 signal shorter than the events -6 outside the HDF5 subset read here
//   -7 a compressed dataset and no libz
int64_t nr_fast5_compact(
    const char* path, const char* group, const char* subgroup, int qlen,
    uint8_t* bases_out, int64_t bases_cap,
    double* shift_out, double* scale_out,
    int16_t* csig_out, int64_t csig_cap,
    int32_t* pos0_out, uint8_t* vlen_out, uint16_t* feats_out,
    int64_t* counts_out) {
  using namespace h5;
  if (qlen < 2 || qlen > 255 || bases_cap < 0 || csig_cap < 0) return E_INVALID;
  try {
    Reader r(path);
    const std::string analyses = std::string("/Analyses/") + group;

    // ---- the version attribute and the events table
    const Node g = walk(r, analyses);
    const auto g_attrs = r.attrs(g.addr);
    const Node ev = walk(r, analyses + "/" + subgroup + "/Events");
    if (ev.group) bad();
    const DType& et = ev.ds.dtype;
    if (et.cls != COMPOUND) unsupported();
    if (ev.ds.shape.size() != 1) unsupported();
    const Member* m_start = member(et, "start");
    const Member* m_length = member(et, "length");
    const Member* m_mean = member(et, "mean");
    const Member* m_stdv = member(et, "stdv");
    const Member* m_state = member(et, "model_state");
    const Member* m_move = member(et, "move");
    for (const Member* m : {m_start, m_length, m_mean, m_stdv, m_move})
      if (!is_number(m->t)) unsupported();
    if (m_state->t.cls != STRING || m_state->t.size < 3) unsupported();
    std::vector<uint8_t> ev_store;
    const Span ev_raw = r.raw(ev.ds, &ev_store);
    const uint64_t n_ev = ev.ds.shape[0];
    if (et.size == 0 || n_ev > ev_raw.n / et.size) bad();

    // ---- /Raw/Reads: every member is opened; the first in name order
    const Node reads = walk(r, "/Raw/Reads/");
    if (!reads.group) bad();
    const auto read_links = r.links(reads.addr);
    for (const auto& kv : read_links)
      if (!r.is_group(kv.second)) r.dataset(kv.second);
    if (read_links.empty()) bad();
    for (const auto& kv : read_links)    // Python re-walks each name as a path
      if (kv.first.empty() || kv.first.find('/') != std::string::npos) unsupported();
    const std::string read_name = read_links.begin()->first;

    // ---- legacy seconds: start and length * 4000, less start_time
    const auto ver = g_attrs.find("version");
    const bool legacy = ver == g_attrs.end() || version_attr_legacy(ver->second);
    double start_time = 0.0;
    if (legacy) {
      const auto ra = r.attrs(read_links.begin()->second);
      const auto st = ra.find("start_time");
      if (st == ra.end()) bad();
      const Attr& a = st->second;
      if (!a.shape.empty() || !is_number(a.dtype)) unsupported();
      start_time = convert<double>(a.raw.p, a.dtype);
    }

    // ---- move-semantics decode (io/fast5.decode_events): per event, its
    // start and how many bases it emits (move 0: none, 2: two, else one)
    std::vector<int64_t> ev_start(n_ev);
    std::vector<uint8_t> emits(n_ev);
    int64_t total = 0;
    for (uint64_t e = 0; e < n_ev; ++e) {
      const uint8_t* rec = ev_raw.p + e * et.size;
      double s = convert<double>(rec + m_start->off, m_start->t);
      if (legacy) s = s * 4000.0 - start_time;
      ev_start[e] = f64_to_i64(s);
      const uint8_t* mv = rec + m_move->off;
      emits[e] = equals(mv, m_move->t, 0) ? 0 : equals(mv, m_move->t, 2) ? 2 : 1;
      total += emits[e];
    }
    if (total < 2) return E_EVENTS;
    std::vector<int64_t> starts(total);
    std::vector<float> abm(total), absd(total);
    std::vector<uint8_t> bases(total);
    int64_t k = 0;
    for (uint64_t e = 0; e < n_ev; ++e) {
      if (emits[e] == 0) continue;
      const uint8_t* rec = ev_raw.p + e * et.size;
      const uint8_t* state = rec + m_state->off;
      const float mean = convert<float>(rec + m_mean->off, m_mean->t);
      const float stdv = convert<float>(rec + m_stdv->off, m_stdv->t);
      if (emits[e] == 2) {
        starts[k] = ev_start[e];
        bases[k] = state[1];
        abm[k] = mean;
        absd[k] = stdv;
        ++k;
        starts[k] = int64_t(uint64_t(ev_start[e]) + 2);
      } else {
        starts[k] = ev_start[e];
      }
      bases[k] = state[2];
      abm[k] = mean;
      absd[k] = stdv;
      ++k;
    }
    for (uint8_t c : bases)
      if (c >= 0x80) bad();                      // bases.decode("ascii")
    // base_durations: diff of starts (int64, wrapping), the 3/5 tail rule
    std::vector<double> dur(total);
    for (int64_t i = 0; i + 1 < total; ++i)
      dur[i] = double(int64_t(uint64_t(starts[i + 1]) - uint64_t(starts[i])));
    dur[total - 1] =
        int64_t(uint64_t(starts[total - 1]) - uint64_t(starts[total - 2])) < 5
            ? 3.0 : 5.0;

    // ---- the signal, as int16
    const Node sn = walk(r, "/Raw/Reads/" + read_name + "/Signal");
    if (sn.group) bad();
    const DType& stype = sn.ds.dtype;
    if (!is_number(stype) || sn.ds.shape.size() != 1) unsupported();
    std::vector<uint8_t> sig_store;
    const Span sig_raw = r.raw(sn.ds, &sig_store);
    const int64_t n_sig = int64_t(sn.ds.shape[0]);
    if (uint64_t(n_sig) > sig_raw.n / stype.size) bad();
    if (double(n_sig) < std::trunc(double(starts[total - 1]) + dur[total - 1]))
      return E_SIGNAL;

    // ---- compact_read: the tail signal[rsr:], int32 starts from it
    const int64_t rsr = starts[0];
    const int64_t t0 = rsr < 0 ? std::max<int64_t>(n_sig + rsr, 0)
                               : std::min<int64_t>(rsr, n_sig);
    const int64_t n_tail = n_sig - t0;
    std::vector<int32_t> rel(total);
    for (int64_t i = 0; i < total; ++i)
      rel[i] = int32_t(uint32_t(uint64_t(starts[i]) - uint64_t(rsr)));
    // _starts_in_range
    if (n_tail < 1 || rel[0] < 0 || int64_t(rel[total - 1]) >= n_tail)
      return E_INVALID;
    for (int64_t i = 0; i + 1 < total; ++i)
      if (rel[i + 1] < rel[i]) return E_INVALID;
    std::vector<int16_t> tail(n_tail);
    if (stype.cls == FIXED && stype.size == 2)   // int16 or uint16: the bits
      std::memcpy(tail.data(), sig_raw.p + t0 * 2, size_t(n_tail) * 2);
    else
      for (int64_t i = 0; i < n_tail; ++i)
        tail[i] = to_i16(sig_raw.p + (t0 + i) * stype.size, stype);
    std::vector<float> dur32(total);
    for (int64_t i = 0; i < total; ++i) dur32[i] = float(dur[i]);

    const int64_t m = compacted_len(rel.data(), total, n_tail, qlen);
    counts_out[0] = total;
    counts_out[1] = m;
    if (total > bases_cap || m > csig_cap) return E_CAPACITY;
    std::memcpy(bases_out, bases.data(), size_t(total));
    *shift_out = -1e31;
    const int64_t got = compact_core(
        tail.data(), n_tail, rel.data(), total, bases.data(), dur32.data(),
        abm.data(), absd.data(), qlen, shift_out, scale_out, csig_out,
        csig_cap, pos0_out, vlen_out, feats_out);
    if (got < 0) return got;
    return total;
  } catch (const Fail& f) {
    return f.rc;
  } catch (const std::exception&) {     // bad_alloc on a corrupt size
    return E_READ;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Burst file writes (nr_write_files), for io/writers.FileWriter: the reads'
// output files are written off the thread that feeds the card, many in one
// call, with the GIL released for all of them.

#include <cerrno>

extern "C" {

// Write n files: file k is the path k of `paths` (n NUL-terminated paths
// back to back), and holds bytes [ends[k-1], ends[k]) of `data` (ends[-1]
// is 0). Each is opened as Python's open(path, "w") opens it (O_WRONLY |
// O_CREAT | O_TRUNC | O_CLOEXEC, mode 0666 under the umask), written until
// done (retried on EINTR and short writes) and closed; no fsync. errs[k] is
// 0, or the errno of the call that failed; a failed file does not stop the
// others. Returns the number of files that failed.
int64_t nr_write_files(int64_t n, const char* paths, const uint8_t* data,
                       const int64_t* ends, int32_t* errs) {
  int64_t n_failed = 0, start = 0;
  for (int64_t k = 0; k < n; ++k) {
    const char* path = paths;
    paths += std::strlen(paths) + 1;
    const int64_t end = ends[k];
    int err = 0;
    int fd;
    do {
      fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0666);
    } while (fd < 0 && errno == EINTR);
    if (fd < 0) {
      err = errno;
    } else {
      for (int64_t off = start; off < end;) {
        const ssize_t got = ::write(
            fd, data + off, size_t(std::min<int64_t>(end - off, 1 << 30)));
        if (got < 0) {
          if (errno == EINTR) continue;
          err = errno;
          break;
        }
        off += got;
      }
      if (::close(fd) != 0 && err == 0 && errno != EINTR) err = errno;
    }
    errs[k] = err;
    n_failed += err != 0;
    start = end;
  }
  return n_failed;
}

}  // extern "C"
