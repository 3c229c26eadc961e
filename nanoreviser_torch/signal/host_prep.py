"""Per-read signal compaction on the host (copy of ``CompactRead`` and
``compact_read_numpy`` from ``nanoreviser_tpu/signal/host_prep.py:208-335``).

Each read's raw int16 signal is compacted to the union of its per-base
window intervals (gaps wider than the 50-sample window, i.e. translocation
stalls, are dropped), giving ~10 samples per base plus per-base gather
starts, valid lengths and f16 features. ``infer.wire`` byte-packs the result.
After compaction consecutive window starts differ by at most 50 samples.

Behavioral contract (reference preprocessing.py:85-170,
nanorevtrainutils.py:160-169):

* window [st-25, st+25) clamped to the signal tail, zero-padded with the
  reference's symmetric split (left = ceil(pad/2)); the zeroing happens
  after normalization, via the per-row valid length;
* event moments are exact int64 prefix-sum population moments over
  [st, next_st) (last base: the 3/5-rule duration), in f64;
* the 6 feature columns are [color/300, ev_mean/shift, ev_std/scale,
  duration/10, ab_mean, ab_std], rounded once from f64 to f16.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fast5 import ReadData
from .features import BASE_COLOR_TABLE, ascii_codes
from .segmentation import mad_normalizers_int16

QUERY_LEN = 50


@dataclass
class CompactRead:
    """Everything the device batch needs from one read, compacted."""

    bases: str
    csig: np.ndarray       # [M] int16 compacted signal (window-interval union)
    pos0: np.ndarray       # [N] int32 window gather start in csig space
                           #     (= window start - left pad; may be -25..)
    vlen: np.ndarray       # [N] uint8 valid window length
    feats: np.ndarray      # [N, 6] float16 final per-base features
    shift: float           # per-read median (raw DAC units)
    scale: float           # per-read MAD

    @property
    def n_bases(self) -> int:
        return len(self.vlen)

    @property
    def n_samples(self) -> int:
        return len(self.csig)


def compact_read_numpy(rd: ReadData, query_len: int = QUERY_LEN) -> CompactRead:
    """Vectorized numpy compaction + exact f64 moments + f16 features.

    The compacted buffer concatenates the maximal merged runs of overlapping
    window intervals; every window maps to a contiguous [cst, cst+vlen)
    slice of it.
    """
    tail = rd.signal[rd.read_start_rel_to_raw :]
    if not tail.flags.c_contiguous:
        tail = np.ascontiguousarray(tail)
    if rd.mad is not None:
        shift, scale = rd.mad
    else:
        shift, scale = mad_normalizers_int16(tail)
    n_samples = len(tail)
    starts = np.asarray(rd.starts, np.int32)
    n = len(starts)

    ahead = query_len // 2
    win_st = np.maximum(starts - ahead, 0)
    win_en = np.minimum(starts + (query_len - ahead), n_samples)
    vlen = (win_en - win_st).astype(np.uint8)
    left = (query_len - vlen.astype(np.int32) + 1) // 2

    # maximal merged interval runs (window starts/ends are non-decreasing)
    brk = np.flatnonzero(win_st[1:] > win_en[:-1])
    first_idx = np.concatenate([[0], brk + 1])
    last_idx = np.concatenate([brk, [n - 1]])
    ist = win_st[first_idx]
    ien = win_en[last_idx]
    clen = ien - ist
    coff = np.concatenate([[0], np.cumsum(clen[:-1], dtype=np.int64)])
    m_total = int(coff[-1] + clen[-1])

    iid = np.zeros(n, np.int64)
    iid[brk + 1] = 1
    np.cumsum(iid, out=iid)
    cst = win_st.astype(np.int64) - ist[iid] + coff[iid]
    pos0 = (cst - left).astype(np.int32)

    csig = np.empty(m_total, np.int16)
    for k in range(len(first_idx)):
        o = coff[k]
        csig[o : o + clen[k]] = tail[ist[k] : ien[k]]

    # exact prefix-sum event moments over [st, next_st)
    last_dur = int(rd.lengths[-1])
    ends = np.empty(n, np.int32)
    ends[:-1] = starts[1:]
    ends[-1] = min(starts[-1] + last_dur, n_samples)
    sig_i32 = tail.astype(np.int32)
    csum = np.empty(n_samples + 1, np.int64)
    csum[0] = 0
    np.cumsum(sig_i32, dtype=np.int64, out=csum[1:])
    csum2 = np.empty(n_samples + 1, np.int64)
    csum2[0] = 0
    np.cumsum(sig_i32 * sig_i32, dtype=np.int64, out=csum2[1:])
    cnt = np.maximum((ends - starts).astype(np.float64), 1.0)
    ssum = (csum[ends] - csum[starts]).astype(np.float64)
    ssum2 = (csum2[ends] - csum2[starts]).astype(np.float64)
    mean = ssum / cnt
    std = np.sqrt(np.maximum(ssum2 / cnt - mean * mean, 0.0))

    feats = np.empty((n, 6), np.float16)
    feats[:, 0] = BASE_COLOR_TABLE[ascii_codes(rd.bases)] * (1.0 / 300.0)
    feats[:, 1] = mean / shift
    feats[:, 2] = std / scale
    feats[:, 3] = np.asarray(rd.lengths, np.float64) * 0.1
    feats[:, 4] = rd.ab_mean
    feats[:, 5] = rd.ab_std

    return CompactRead(
        bases=rd.bases, csig=csig, pos0=pos0, vlen=vlen, feats=feats,
        shift=float(shift), scale=float(scale),
    )
