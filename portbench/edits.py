"""Edit distances between long reads that differ in a few places, for the
basecaller cells' ``edit_rate``.

``distances(pairs)`` cuts each pair at anchors, then takes ``banded`` of
every piece at once. An anchor is a 32-byte run of a, taken every 400
bytes, that occurs once in a within 200 bytes of it and once in b within
200 bytes of where the anchors before it put it; a and b are cut at the
run's start in each. A run that repeats nearby (the tandem repeats that a
model with random weights writes) is no anchor: taking one copy for
another would cut the two reads out of step and count hundreds of edits
between reads that differ in a few. The pieces' distances add up to the
distance of the best alignment through the anchors: the edit distance
when one of the best alignments matches each anchor's run to itself, and
at least it otherwise.

``banded(pairs, band)`` computes, for every (a, b) pair of byte strings at
once, the Levenshtein distance (unit costs) over the cells within ``band``
of the diagonal that runs from (0, 0) to (len a, len b). Every path with
at most ``band`` net indels away from that diagonal lies in the band, so the
result is the edit distance whenever the best alignment stays there, and
at least it otherwise: a reading the judge takes is never below the truth.

Row i of the table is computed for every pair in one pass of array
operations: first the diagonal and upward moves, then the leftward moves
as a running minimum (``D[j] = min over j' <= j of t[j'] + j - j'``).
"""

from __future__ import annotations

import numpy as np

BIG = np.int64(1) << 40


def banded(pairs: list, band: int = 128) -> list[int]:
    if not pairs:
        return []
    order = sorted(range(len(pairs)), key=lambda p: -len(pairs[p][0]))
    a_list = [np.frombuffer(pairs[p][0], np.uint8) for p in order]
    b_list = [np.frombuffer(pairs[p][1], np.uint8) for p in order]
    n = np.array([len(a) for a in a_list], np.int64)
    a_mat = np.zeros((len(pairs), int(n.max(initial=0)) + 1), np.uint8)
    for k, a in enumerate(a_list):
        a_mat[k, : len(a)] = a
    m = np.array([len(b) for b in b_list], np.int64)
    width = 2 * band + 1
    w = np.arange(width, dtype=np.int64)
    # b padded so that column j (1-based) reads b_pad[j + band]
    b_off = np.concatenate([[0], np.cumsum(m + 2 * band + 2)])[:-1]
    b_pad = np.concatenate([np.concatenate([np.full(band + 1, 255, np.uint8), b,
                                            np.full(band + 1, 255, np.uint8)])
                            for b in b_list])
    result = np.zeros(len(pairs), np.int64)

    def lo(i, idx):
        # the band of row i starts at its diagonal column less the band
        return (i * m[idx]) // np.maximum(n[idx], 1) - band

    active = len(pairs)
    idx = np.arange(active)
    lo_prev = lo(0, idx)
    cols = lo_prev[:, None] + w[None, :]
    d = np.where((cols >= 0) & (cols <= m[:, None]), cols, BIG)
    for i in range(1, int(n.max(initial=0)) + 1):
        while active and n[active - 1] < i:
            active -= 1
        if not active:
            break
        idx = idx[:active]
        d = d[:active]
        lo_i = lo(i, idx)
        shift = (lo_i - lo_prev[:active])[:, None]          # 0, 1, 2 ...
        prev = np.concatenate([d, np.full((active, 3 + int(shift.max(initial=0))),
                                          BIG)], 1)
        up_at = np.clip(w[None, :] + shift, 0, prev.shape[1] - 1)
        diag_at = w[None, :] + shift - 1
        up = np.take_along_axis(prev, up_at, 1)
        diag = np.where(diag_at >= 0,
                        np.take_along_axis(prev, np.maximum(diag_at, 0), 1), BIG)
        cols = lo_i[:, None] + w[None, :]
        a_i = a_mat[:active, i - 1 : i]
        b_j = b_pad[np.clip(b_off[idx][:, None] + cols + band, 0, len(b_pad) - 1)]
        cost = (b_j != a_i).astype(np.int64)
        t = np.minimum(up + 1, diag + cost)
        valid = (cols >= 0) & (cols <= m[idx][:, None])
        t = np.where(valid, t, BIG)
        t = np.where(cols == 0, i, t)
        d = np.minimum.accumulate(t - w[None, :], axis=1) + w[None, :]
        d = np.where(valid, np.minimum(d, BIG), BIG)
        lo_prev = np.concatenate([lo_i, lo_prev[active:]])
        done = n[idx] == i
        for k in np.flatnonzero(done):
            at = m[idx[k]] - lo_i[k]
            result[order[idx[k]]] = d[k, at] if 0 <= at < width else BIG
    for k in np.flatnonzero(n == 0):
        result[order[k]] = m[k]
    return [int(x) for x in result]


def _once(s: bytes, run: bytes, lo: int, hi: int) -> int:
    """Where ``run`` starts in ``s[lo:hi]`` if it occurs there exactly once
    (overlapping occurrences counted), else -1."""
    at = s.find(run, lo, hi)
    if at < 0 or s.find(run, at + 1, hi) >= 0:
        return -1
    return at


def distances(pairs: list, every: int = 400, k: int = 32, reach: int = 200,
              band: int = 64) -> list[int]:
    pieces, owner = [], []
    for p, (a, b) in enumerate(pairs):
        i0 = j0 = 0
        for i in range(every, len(a) - k, every):
            run = a[i : i + k]
            if _once(a, run, max(i0, i - reach), i + reach + k) != i:
                continue
            want = i + (j0 - i0)
            j = _once(b, run, max(j0, want - reach), want + reach + k)
            if j < 0:
                continue
            pieces.append((a[i0:i], b[j0:j]))
            owner.append(p)
            i0, j0 = i, j
        pieces.append((a[i0:], b[j0:]))
        owner.append(p)
    out = [0] * len(pairs)
    for p, d in zip(owner, banded(pieces, band)):
        out[p] += d
    return out
