"""Per-base feature assembly (copy of ``nanoreviser_tpu/signal/features.py``).

The models consume, per base, a 6-dim feature vector (reference
nanorevtrainutils.py:160-169):

    [ base_color/300, event_mean/shift, event_std/scale,
      duration/10, ab_mean, ab_std ]

plus a 50-sample normalized raw-signal window (``signal.segmentation``).

Base encodings (reference preprocessing.py:173-180):
    color: A=250 G=180 T=100 C=30 other=0
    label: A=5 G=4 T=3 C=2 '-'=1 'D'=0 (and other=0)
"""

from __future__ import annotations

import numpy as np

# 256-entry ascii lookup tables
BASE_COLOR_TABLE = np.zeros(256, dtype=np.float64)
for _b, _c in {"A": 250, "G": 180, "T": 100, "C": 30}.items():
    BASE_COLOR_TABLE[ord(_b)] = _c

BASE_LABEL_TABLE = np.zeros(256, dtype=np.int32)
for _b, _l in {"A": 5, "G": 4, "T": 3, "C": 2, "-": 1, "D": 0}.items():
    BASE_LABEL_TABLE[ord(_b)] = _l

LABEL_TO_BASE = np.array(list("D-CTGA"))  # label 0..5 -> base char


def ascii_codes(bases: str | np.ndarray) -> np.ndarray:
    if isinstance(bases, str):
        return np.frombuffer(bases.encode("ascii"), dtype=np.uint8)
    arr = np.asarray(bases)
    if arr.dtype.kind in ("S", "U"):
        return np.frombuffer("".join(arr.tolist()).encode("ascii"), dtype=np.uint8)
    return arr.astype(np.uint8)


def base_colors(bases: str | np.ndarray) -> np.ndarray:
    return BASE_COLOR_TABLE[ascii_codes(bases)]


def base_labels(bases: str | np.ndarray) -> np.ndarray:
    return BASE_LABEL_TABLE[ascii_codes(bases)]


def assemble_features(
    bases: str | np.ndarray,
    event_mean: np.ndarray,
    event_std: np.ndarray,
    durations: np.ndarray,
    ab_mean: np.ndarray,
    ab_std: np.ndarray,
    shift: float,
    scale: float,
    dtype=np.float32,
) -> np.ndarray:
    """Stack the 6 per-base scalar features into [N, 6]."""
    colors = base_colors(bases) / 300.0
    feats = np.stack(
        [
            colors,
            np.asarray(event_mean, dtype=np.float64) / shift,
            np.asarray(event_std, dtype=np.float64) / scale,
            np.asarray(durations, dtype=np.float64) / 10.0,
            np.asarray(ab_mean, dtype=np.float64),
            np.asarray(ab_std, dtype=np.float64),
        ],
        axis=1,
    )
    return feats.astype(dtype)
