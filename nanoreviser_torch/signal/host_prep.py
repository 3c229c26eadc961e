"""Per-read host preparation: the windowed prep and the compaction (copy of
``PreppedRead``, ``prep_read``, ``prep_read_numpy``, ``prep_fast5``,
``CompactRead`` and ``compact_read_numpy`` from
``nanoreviser_tpu/signal/host_prep.py:53-335``).

The windowed prep gathers each base's raw 50-sample window on the host
(``PreppedRead.win``, int16) for the pre-gathered-window path
(``signal.device_prep`` -> ``models.fused.signal_branch_apply`` ->
``ops.reviser_kernel.stack_logits_multi``). The compacted prep is what the
streaming engine uploads: each read's raw int16 signal is compacted to the
union of its per-base window intervals (gaps wider than the 50-sample
window, i.e. translocation stalls, are dropped), giving ~10 samples per base
plus per-base gather starts, valid lengths and f16 features. ``infer.wire``
byte-packs the result.
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
class PreppedRead:
    """Everything the pre-gathered-window path needs from one read."""

    bases: str
    win: np.ndarray        # [N, QUERY_LEN] int16 raw DAC (padding masked later)
    vlen: np.ndarray       # [N] uint8 valid window length (left pad derived)
    feats: np.ndarray      # [N, 6] float16 final per-base features
    shift: float           # per-read median (raw DAC units)
    scale: float           # per-read MAD

    @property
    def n_bases(self) -> int:
        return len(self.vlen)


def prep_read(rd: ReadData, query_len: int = QUERY_LEN) -> PreppedRead:
    """ReadData -> PreppedRead through the numpy path.

    The JAX package dispatches to its native C++ library first; the port has
    no native layer yet, so this calls :func:`prep_read_numpy` directly."""
    return prep_read_numpy(rd, query_len)


def prep_read_numpy(rd: ReadData, query_len: int = QUERY_LEN) -> PreppedRead:
    """ReadData -> PreppedRead, vectorized numpy (int32 index math; the tail
    is edge-padded so the window gather needs no clip)."""
    tail = rd.signal[rd.read_start_rel_to_raw :]
    if not tail.flags.c_contiguous:
        tail = np.ascontiguousarray(tail)
    if rd.mad is not None:
        shift, scale = rd.mad
    else:
        shift, scale = mad_normalizers_int16(tail)
    n_samples = len(tail)
    starts = np.asarray(rd.starts, np.int32)

    ahead = query_len // 2
    win_st = np.maximum(starts - ahead, 0)
    win_en = np.minimum(starts + (query_len - ahead), n_samples)
    vlen = win_en - win_st
    left = (query_len - vlen + 1) // 2

    # gather positions range over [-q, n_samples + q); pad the tail by q on
    # both sides so no clip pass is needed (out-of-range cols are masked
    # after normalization via vlen anyway)
    padded = np.empty(n_samples + 2 * query_len, np.int16)
    padded[:query_len] = 0
    padded[query_len : query_len + n_samples] = tail
    padded[query_len + n_samples :] = 0
    cols = np.arange(query_len, dtype=np.int32)
    pos = (win_st - left + query_len)[:, None] + cols[None, :]
    win = padded[pos]

    mean, std = _event_moments(tail, starts, rd.lengths)
    feats = _features_f16(rd, mean, std, shift, scale)
    return PreppedRead(
        bases=rd.bases,
        win=np.ascontiguousarray(win, dtype=np.int16),
        vlen=vlen.astype(np.uint8),
        feats=feats,
        shift=float(shift),
        scale=float(scale),
    )


def prep_fast5(
    path: str,
    basecall_group: str = "Basecall_1D_000",
    basecall_subgroup: str = "BaseCalled_template",
) -> PreppedRead:
    """Decode + prep one fast5."""
    from ..io.fast5 import get_read_data

    return prep_read(get_read_data(path, basecall_group, basecall_subgroup))


def _event_moments(tail: np.ndarray, starts: np.ndarray, lengths):
    """Exact prefix-sum event moments over [st, next_st); the last base
    spans its 3/5-rule duration, clamped to the tail. Squares fit int32
    (|DAC| < 2^15), accumulation is int64."""
    n_samples = len(tail)
    n = len(starts)
    last_dur = int(lengths[-1])
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
    return mean, std


def _features_f16(rd: ReadData, mean, std, shift, scale) -> np.ndarray:
    """The 6 feature columns, rounded once from f64 to f16."""
    feats = np.empty((len(mean), 6), np.float16)
    feats[:, 0] = BASE_COLOR_TABLE[ascii_codes(rd.bases)] * (1.0 / 300.0)
    feats[:, 1] = mean / shift
    feats[:, 2] = std / scale
    feats[:, 3] = np.asarray(rd.lengths, np.float64) * 0.1
    feats[:, 4] = rd.ab_mean
    feats[:, 5] = rd.ab_std
    return feats


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

    mean, std = _event_moments(tail, starts, rd.lengths)
    feats = _features_f16(rd, mean, std, shift, scale)
    return CompactRead(
        bases=rd.bases, csig=csig, pos0=pos0, vlen=vlen, feats=feats,
        shift=float(shift), scale=float(scale),
    )
