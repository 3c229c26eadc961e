"""Revision merge: combine model1/model2 predictions with the original bases.

Copy of ``nanoreviser_tpu/infer/merge.py`` (numpy only).

Branch semantics (parity with reference output_handeler.py:104-142,
``get_base_1``/``get_base_2`` — both share the same merge rules; get_base_1
additionally converts integer labels to chars):

per position i with y = model1 base-char, y2 = model2 base-char, b = original:
  * y == y2 and y in ACGT            -> emit y        (substitution fix)
  * y == 'D' and y2 in ACGT          -> emit b, y2    (recover deleted base)
  * y == '-' and y2 == '-'           -> emit nothing  (drop inserted base)
  * otherwise                        -> emit b
A copy of the first model1 char is prepended (reference :107) and every '-'
is filtered from the final string (reference :121).

Label mapping: model1 classes are labels {0:'D',1:'-',2:'C',3:'T',4:'G',5:'A'};
model2 classes c∈[0,5) correspond to labels c+1 (training target is
``refvals2 - 1``, reference nanorevtrainutils.py:213).

Implementation is vectorized numpy (emission counts + repeat), not a per-base
Python loop.
"""

from __future__ import annotations

import numpy as np

from ..signal.features import LABEL_TO_BASE

_ACGT = np.zeros(256, dtype=bool)
for _c in b"ACGT":
    _ACGT[_c] = True

_DASH = ord("-")
_D = ord("D")


_LABEL_CODES = np.frombuffer("".join(LABEL_TO_BASE).encode("ascii"), dtype=np.uint8)


def labels_to_bases(labels: np.ndarray, model2: bool = False) -> np.ndarray:
    """Class indices -> base-char codes (uint8). model2 classes are label-1."""
    labels = np.asarray(labels)
    if model2:
        labels = labels + 1
    return _LABEL_CODES[np.clip(labels, 0, 5)]


def merge_core(bases: np.ndarray, y1: np.ndarray, y2: np.ndarray) -> np.ndarray:
    """Vectorized merge over aligned uint8 char arrays (truncates to min len).

    Returns the merged uint8 char array BEFORE '-' filtering.
    """
    n = min(len(bases), len(y1), len(y2))
    b, y, z = bases[:n], y1[:n], y2[:n]

    sub_fix = (y == z) & _ACGT[y]
    del_fix = (y == _D) & _ACGT[z]
    ins_drop = (y == _DASH) & (z == _DASH) & ~sub_fix & ~del_fix

    counts = np.where(del_fix, 2, np.where(ins_drop, 0, 1))
    first = np.where(sub_fix, y, b)      # del_fix first char is b; else-branch b
    total = int(counts.sum())
    out = np.empty(total, dtype=np.uint8)
    offs = np.cumsum(counts) - counts
    emit1 = counts >= 1
    out[offs[emit1]] = first[emit1]
    out[offs[del_fix] + 1] = z[del_fix]
    return out


def _merge_core_with_quality(
    bases: np.ndarray, y1: np.ndarray, y2: np.ndarray,
    q1: np.ndarray, q2: np.ndarray, fill_q: int,
) -> tuple[np.ndarray, np.ndarray]:
    """merge_core plus a parallel phred-value array (uint8, 0-93).

    First emitted char carries model1's confidence (it made the call);
    a deletion-recovery's inserted char carries model2's. ``fill_q`` is
    unused here but kept for signature symmetry.
    """
    del fill_q
    n = min(len(bases), len(y1), len(y2))
    b, y, z = bases[:n], y1[:n], y2[:n]
    q1, q2 = q1[:n], q2[:n]

    sub_fix = (y == z) & _ACGT[y]
    del_fix = (y == _D) & _ACGT[z]
    ins_drop = (y == _DASH) & (z == _DASH) & ~sub_fix & ~del_fix

    counts = np.where(del_fix, 2, np.where(ins_drop, 0, 1))
    first = np.where(sub_fix, y, b)
    total = int(counts.sum())
    out = np.empty(total, dtype=np.uint8)
    out_q = np.empty(total, dtype=np.uint8)
    offs = np.cumsum(counts) - counts
    emit1 = counts >= 1
    out[offs[emit1]] = first[emit1]
    out_q[offs[emit1]] = q1[emit1]
    out[offs[del_fix] + 1] = z[del_fix]
    out_q[offs[del_fix] + 1] = q2[del_fix]
    return out, out_q


def merge_revision_with_quality(
    bases: str,
    y1_labels: np.ndarray,
    y2_labels: np.ndarray,
    q1: np.ndarray,
    q2: np.ndarray,
    align: str = "reference",
    window: int = 13,
    fill_q: int = 20,
    center_offset: int | None = None,
) -> tuple[str, str]:
    """merge_revision plus a phred-33 quality string from the models' max
    softmax probabilities (the reference's Guppy path emitted real qualities,
    output_handeler.py:86-102; its dormant model path had none). Bases the
    model did not cover (align="center" head/tail) get ``fill_q``.
    """
    base_codes = np.frombuffer(bases.encode("ascii"), dtype=np.uint8)
    y1 = labels_to_bases(y1_labels, model2=False)
    y2 = labels_to_bases(y2_labels, model2=True)
    q1 = np.asarray(q1, np.uint8)
    q2 = np.asarray(q2, np.uint8)

    if align == "reference":
        merged, mq = _merge_core_with_quality(base_codes, y1, y2, q1, q2, fill_q)
        merged = np.concatenate([y1[:1], merged])
        mq = np.concatenate([q1[:1], mq])
    elif align == "center":
        set_bef = (window - 1) // 2 if center_offset is None else center_offset
        covered, cq = _merge_core_with_quality(
            base_codes[set_bef : set_bef + len(y1)], y1, y2, q1, q2, fill_q
        )
        head = base_codes[:set_bef]
        tail = base_codes[set_bef + min(len(y1), len(y2)) :]
        merged = np.concatenate([head, covered, tail])
        mq = np.concatenate(
            [
                np.full(len(head), fill_q, np.uint8),
                cq,
                np.full(len(tail), fill_q, np.uint8),
            ]
        )
    else:
        raise ValueError(f"unknown align mode {align!r}")

    keep = merged != _DASH
    merged, mq = merged[keep], mq[keep]
    return (
        merged.tobytes().decode("ascii"),
        (mq + 33).astype(np.uint8).tobytes().decode("ascii"),
    )


def revision_stats(
    bases: str,
    y1_labels: np.ndarray,
    y2_labels: np.ndarray,
    center_offset: int = 0,
) -> dict:
    """Edit-op counts the merge would apply (model-path accuracy evidence).

    Returns counts over the covered positions:
      substitutions  — y1 == y2 in ACGT and != the original base
      confirmations  — y1 == y2 in ACGT and == the original base
      deletions_recovered — y1 == 'D', y2 in ACGT (a base is inserted)
      insertions_dropped  — y1 == y2 == '-' (the original base is removed)
      center_agreement    — fraction of covered positions where model1's
                            call equals the original base (discriminativeness
                            sanity: most bases in a real read are correct)
    """
    base_codes = np.frombuffer(bases.encode("ascii"), dtype=np.uint8)
    base_codes = base_codes[center_offset:]
    y = labels_to_bases(y1_labels, model2=False)
    z = labels_to_bases(y2_labels, model2=True)
    n = min(len(base_codes), len(y), len(z))
    b, y, z = base_codes[:n], y[:n], z[:n]

    both = (y == z) & _ACGT[y]
    subs = int((both & (y != b)).sum())
    confirms = int((both & (y == b)).sum())
    dels = int(((y == _D) & _ACGT[z]).sum())
    ins = int(((y == _DASH) & (z == _DASH)).sum())
    agree = float((y == b).mean()) if n else 0.0
    return {
        "covered": n,
        "substitutions": subs,
        "confirmations": confirms,
        "deletions_recovered": dels,
        "insertions_dropped": ins,
        "center_agreement": agree,
        "edits": subs + dels + ins,
    }


def calibrate_center_offset(
    bases: str, y1_labels: np.ndarray, window: int = 13,
    min_agreement: float = 0.5, min_n: int = 64,
) -> tuple[int, float]:
    """Empirical window-center offset: argmax over shifts k of
    agreement(model1 char for window i, base i+k).

    Needed because the offset is a property of the WEIGHTS, not the code:
    weights trained by this repo's pipeline encode k = (window-1)//2 = 6,
    but the reference's shipped weights empirically encode k = 5 (an
    off-by-one inside its own never-run inference path). On a real read most
    bases are correct, so a discriminative model shows ~0.9+ agreement at
    its true offset and ~0.25 (the base prior) elsewhere. Returns
    (offset, agreement); falls back to (window-1)//2 when no shift clears
    ``min_agreement`` (degenerate model — callers may warn). ``min_n`` is
    the per-shift sample floor; the engine lowers it for end-of-stream
    calibration when every read in the stream was short."""
    b = np.frombuffer(bases.encode("ascii"), dtype=np.uint8)
    y = labels_to_bases(np.asarray(y1_labels), model2=False)
    best_k, best_a = (window - 1) // 2, -1.0
    for k in range(window + 1):
        n = min(len(b) - k, len(y))
        if n < min_n:
            continue
        a = float((y[:n] == b[k : k + n]).mean())
        if a > best_a:
            best_k, best_a = k, a
    if best_a < min_agreement:
        return (window - 1) // 2, best_a
    return best_k, best_a


def merge_revision(
    bases: str,
    y1_labels: np.ndarray,
    y2_labels: np.ndarray,
    align: str = "reference",
    window: int = 13,
    center_offset: int | None = None,
) -> str:
    """Merge predictions into the revised read sequence.

    align="reference": reproduces the dormant reference wiring — predictions
    zip against the read from position 0 (get_base_1 semantics) with the
    first model1 char prepended; the tail beyond the prediction count is
    dropped by zip truncation. Because window i's prediction actually
    encodes base i+offset, this emits the model-consensus sequence rotated
    by the offset — kept for strict reference parity only.

    align="center": predictions are placed at their window-center base
    (window i predicts base i + center_offset; default (window-1)//2);
    uncovered head/tail bases pass through unchanged. Production mode —
    the engine calibrates center_offset per weights
    (calibrate_center_offset).
    """
    base_codes = np.frombuffer(bases.encode("ascii"), dtype=np.uint8)
    y1 = labels_to_bases(y1_labels, model2=False)
    y2 = labels_to_bases(y2_labels, model2=True)

    if align == "reference":
        merged = merge_core(base_codes, y1, y2)
        merged = np.concatenate([y1[:1], merged])
    elif align == "center":
        set_bef = (window - 1) // 2 if center_offset is None else center_offset
        covered = merge_core(base_codes[set_bef : set_bef + len(y1)], y1, y2)
        merged = np.concatenate(
            [
                base_codes[:set_bef],
                covered,
                base_codes[set_bef + min(len(y1), len(y2)) :],
            ]
        )
    else:
        raise ValueError(f"unknown align mode {align!r}")

    merged = merged[merged != _DASH]
    return merged.tobytes().decode("ascii")
