"""Exact per-read MAD normalizers (copy of ``nanoreviser_tpu/signal/
segmentation.py:40-80``).

``shift`` is the median of the raw-signal tail and ``scale`` its median
absolute deviation, both in raw DAC units (reference preprocessing.py:85-170).
The int16 variant counts a histogram instead of sorting and is bit-identical
to numpy's median on int16 data.
"""

from __future__ import annotations

import numpy as np


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
