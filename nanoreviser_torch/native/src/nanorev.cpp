// Host-side per-read preparation for the serving path and the training
// labeller's banded aligner, in C++.
//
// The port's own copy of the parts of nanoreviser_tpu/native/src/nanorev.cpp
// that model-path revision and training call (helpers :36-151, the banded
// aligner nr_banded_sw :162-255, nr_prep_read :280, nr_compact_read :382,
// nr_encode_wire :793-887). The HDF5 ingest is not here.
//
// Every entry mirrors a numpy function of the package bit for bit:
//   nr_prep_read    signal/host_prep.prep_read_numpy (inside each row's
//                   valid window span; the pad columns are zero here)
//   nr_compact_read signal/host_prep.compact_read_numpy
//   nr_encode_wire  infer/wire.encode_read
//   nr_banded_sw    align/sw.banded_sw_torch (ops, j_start and score equal;
//                   its f32 score arithmetic keeps the JAX scan's order)
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
