"""Per-base feature tables (copy of ``nanoreviser_tpu/signal/features.py``).

The models consume, per base, a 6-dim feature vector (reference
nanorevtrainutils.py:160-169):

    [ base_color/300, event_mean/shift, event_std/scale,
      duration/10, ab_mean, ab_std ]

Base encodings (reference preprocessing.py:173-180):
    color: A=250 G=180 T=100 C=30 other=0
    label: 0..5 = 'D', '-', 'C', 'T', 'G', 'A'
"""

from __future__ import annotations

import numpy as np

BASE_COLOR_TABLE = np.zeros(256, dtype=np.float64)
for _b, _c in {"A": 250, "G": 180, "T": 100, "C": 30}.items():
    BASE_COLOR_TABLE[ord(_b)] = _c

LABEL_TO_BASE = np.array(list("D-CTGA"))  # label 0..5 -> base char


def ascii_codes(bases: str | np.ndarray) -> np.ndarray:
    if isinstance(bases, str):
        return np.frombuffer(bases.encode("ascii"), dtype=np.uint8)
    arr = np.asarray(bases)
    if arr.dtype.kind in ("S", "U"):
        return np.frombuffer("".join(arr.tolist()).encode("ascii"), dtype=np.uint8)
    return arr.astype(np.uint8)
