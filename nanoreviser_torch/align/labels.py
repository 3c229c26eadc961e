"""Alignment columns -> per-base training labels (vectorized).

Copy of ``nanoreviser_tpu/align/labels.py`` (numpy). Parity with reference
preprocessing.py:18-82:

* ``clean_read_map_ref``: collapse alignment columns into per-read-base label
  pairs. Looking at consecutive column pairs (i, i+1):
    - map[i] in MXI, map[i+1] in MXI -> keep col i (label = ref[i], label2 = ref[i])
    - map[i] in MXI, map[i+1] == D  -> keep col i with map='D',
                                       label='D', label2=ref[i]  (deletion flagged
                                       on the PREVIOUS read base)
    - map[i] == D                   -> drop (runs of D collapse)
  and the final column is always appended unchanged.
* ``fix_raw_starts_for_clipped_bases``: trim clipped leading/trailing bases
  from the per-base arrays and advance read_start_rel_to_raw.
"""

from __future__ import annotations

import numpy as np


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8)


_MXI = np.zeros(256, dtype=bool)
for _c in b"MXI":
    _MXI[_c] = True
_D = ord("D")


def clean_read_map_ref(
    read_vals: str, map_vals: str, ref_vals: str
) -> tuple[str, str, str, str]:
    """Returns (clean_read, clean_map, clean_ref, clean_ref2) as strings."""
    rv, mv, fv = _codes(read_vals), _codes(map_vals), _codes(ref_vals)
    n = len(mv)
    if n == 0:
        return "", "", "", ""

    head_m = mv[:-1]
    next_m = mv[1:]
    keep = _MXI[head_m]
    next_is_del = next_m == _D

    out_read = rv[:-1][keep]
    out_map = np.where(next_is_del, _D, head_m)[keep].astype(np.uint8)
    out_ref = np.where(next_is_del, _D, fv[:-1])[keep].astype(np.uint8)
    out_ref2 = fv[:-1][keep]

    out_read = np.concatenate([out_read, rv[-1:]])
    out_map = np.concatenate([out_map, mv[-1:]])
    out_ref = np.concatenate([out_ref, fv[-1:]])
    out_ref2 = np.concatenate([out_ref2, fv[-1:]])
    return (
        out_read.tobytes().decode(),
        out_map.tobytes().decode(),
        out_ref.tobytes().decode(),
        out_ref2.tobytes().decode(),
    )


def fix_raw_starts_for_clipped_bases(
    start_clipped_bases: int,
    end_clipped_bases: int,
    starts_rel_to_read: np.ndarray,
    event_length: np.ndarray,
    read_start_rel_to_raw: int,
    ab_mean: np.ndarray,
    ab_std: np.ndarray,
):
    """Trim per-base arrays for aligner-clipped bases (reference :18-42)."""
    starts = np.asarray(starts_rel_to_read)
    lengths = np.asarray(event_length)
    ab_mean = np.asarray(ab_mean)
    ab_std = np.asarray(ab_std)

    if start_clipped_bases > 0:
        s = int(start_clipped_bases)
        clipped_obs = int(starts[s])
        ab_mean = ab_mean[s:]
        ab_std = ab_std[s:]
        lengths = lengths[s:]
        starts = starts[s:] - clipped_obs
        read_start_rel_to_raw = int(read_start_rel_to_raw) + clipped_obs

    if end_clipped_bases > 0:
        e = int(end_clipped_bases)
        starts = starts[:-e]
        ab_mean = ab_mean[:-e]
        ab_std = ab_std[:-e]
        lengths = lengths[:-e]

    return starts, lengths, int(read_start_rel_to_raw), ab_mean, ab_std
