"""Per-base signal windowing with MAD normalization, the exact host
reference (copy of ``nanoreviser_tpu/signal/segmentation.py:31-141``).

Behavioral contract (reference preprocessing.py:85-170,
``signal_segmentation``):

* ``shift`` = median of the raw-signal tail, ``scale`` = median absolute
  deviation, both in raw DAC units over the whole tail passed in.
* For each base with start ``st`` (relative to the tail) the 50-sample
  window covers raw ``[st - 25, st + 25)`` clamped to the tail bounds,
  normalized ``(x - shift) / scale``, then zero-padded to exactly 50 with the
  reference's symmetric split: ``left = ceil(pad/2)``, ``right =
  floor(pad/2)``, symmetric even when only one side was clamped.
* Per-base event statistics (mean/std of the un-normalized raw slice
  ``[st, next_st)``; the last base uses ``[st, st + last_dur)``) are
  population moments (ddof=0), from exact int64 prefix sums.

The int16 normalizers count a histogram instead of sorting and are
bit-identical to numpy's median on int16 data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SegmentedSignal:
    windows: np.ndarray      # float32 [N, query_len] normalized signal windows
    event_mean: np.ndarray   # float64 [N] raw event means
    event_std: np.ndarray    # float64 [N] raw event stds (population)
    shift: float             # median of the tail (raw DAC units)
    scale: float             # MAD of the tail (raw DAC units)


def mad_normalizers(signal_tail: np.ndarray) -> tuple[float, float]:
    x = np.asarray(signal_tail, dtype=np.float64)
    shift = float(np.median(x))
    scale = float(np.median(np.abs(x - shift)))
    return shift, scale


def _hist_median_int(counts: np.ndarray, n: int) -> float:
    """Exact numpy-median semantics from an integer histogram."""
    csum = np.cumsum(counts)
    lo_rank = max((n - 1) // 2, 0)
    hi_rank = n // 2
    lo, hi = np.searchsorted(csum, [lo_rank + 1, hi_rank + 1])
    return (float(lo) + float(hi)) / 2.0


def mad_normalizers_int16(signal_tail: np.ndarray) -> tuple[float, float]:
    """Exact (median, MAD) of an int16 signal via histogram counting."""
    x = np.asarray(signal_tail)
    if x.dtype != np.int16:
        raise TypeError(f"expected an int16 signal, got {x.dtype}")
    n = len(x)
    # range-bounded histograms: offsetting by the minimum keeps the bincount
    # output small (real reads span a few thousand distinct DAC values)
    mn = int(x.min())
    xi = x.astype(np.int32)
    xi -= mn
    counts = np.bincount(xi)
    shift = _hist_median_int(counts, n) + mn
    # 2*shift is integral, so 2*|x - shift| is an exact integer
    two_shift = int(round(2.0 * shift))
    dev2 = np.abs(2 * xi - (two_shift - 2 * mn))
    scale = _hist_median_int(np.bincount(dev2), n) * 0.5
    return shift, scale


def segment_signal(
    signal_tail: np.ndarray,
    starts: np.ndarray,
    last_dur: int,
    query_len: int = 50,
    dtype=np.float32,
) -> SegmentedSignal:
    """Windows + event stats for every base, vectorized.

    ``signal_tail`` is the raw signal from ``read_start_rel_to_raw`` on;
    ``starts`` are base starts relative to the tail (int); ``last_dur`` is the
    final base's duration (int).
    """
    query_len = int(query_len)
    if query_len % 2 == 0:
        ahead, tail_len = query_len // 2, query_len // 2
    else:
        # reference trims odd query_len down by one and splits (q/2, 1 + q/2)
        query_len = query_len - 1
        ahead, tail_len = query_len // 2, 1 + query_len // 2

    sig = np.asarray(signal_tail)
    n_samples = len(sig)
    starts = np.asarray(starts, dtype=np.int64)
    shift, scale = mad_normalizers(sig)

    # window bounds [win_st, win_en), clamped like the reference (:111-118)
    win_st = np.maximum(starts - ahead, 0)
    win_en = np.minimum(starts + tail_len, n_samples)
    win_len = win_en - win_st

    pad = query_len - win_len
    left = (pad + 1) // 2          # == ceil(pad/2), for odd and even pads
    # column j holds raw[win_st + j - left], masked outside the valid span
    cols = np.arange(query_len, dtype=np.int64)
    pos = win_st[:, None] + (cols[None, :] - left[:, None])
    valid = (cols[None, :] >= left[:, None]) & (cols[None, :] < (left + win_len)[:, None])
    gathered = sig[np.clip(pos, 0, max(n_samples - 1, 0))].astype(np.float64)
    windows = np.where(valid, (gathered - shift) / scale, 0.0).astype(dtype)

    # event stats over [st, en) with exact integer prefix sums
    ends = np.concatenate([starts[1:], [starts[-1] + int(last_dur)]])
    sig_i64 = sig.astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(sig_i64)])
    csum2 = np.concatenate([[0], np.cumsum(sig_i64 * sig_i64)])
    n = (ends - starts).astype(np.float64)
    ssum = (csum[ends] - csum[starts]).astype(np.float64)
    ssum2 = (csum2[ends] - csum2[starts]).astype(np.float64)
    mean = ssum / n
    var = np.maximum(ssum2 / n - mean * mean, 0.0)
    std = np.sqrt(var)

    return SegmentedSignal(
        windows=windows,
        event_mean=mean,
        event_std=std,
        shift=shift,
        scale=scale,
    )
