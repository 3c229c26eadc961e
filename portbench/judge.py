"""The comparison that decides ``correct`` for a revised read: by how much
must a served label's logit lie below the reference's best for the
program's written read to come out?

The program writes only the revised bases. They follow from its two labels
per window by the merge's rules (window i's pair revises base i + offset):
a pair (y, z) of equal calls in ACGT writes y; y = 'D' with z in ACGT
writes the base and z; y = z = '-' writes nothing; any other pair writes
the base. Each label has a cost: the reference's best logit less the
label's, per model. ``widest_gap`` finds, by dynamic programming over the
windows and the written characters, the labels that write exactly the
program's read with the smallest largest cost: the widest gap the
program's read needs. A read the reference writes itself needs 0; one that
no labels can write needs infinity.

The search keeps, per window, the 2 * band + 1 positions in the written
read around the likeliest one, so it follows a read whose length drifts
from the reference's by any amount, one step at a time. The likeliest
position is the one reached with the smallest sum of costs (a second
program over the same positions): the largest cost ties on many paths once
one costly window has passed, the sum does not.
"""

from __future__ import annotations

import numpy as np

INF = np.float32(np.inf)
CODES = np.full(256, 5, np.int64)            # A C G T N -> 0..4, others 5
for _i, _c in enumerate(b"ACGTN"):
    CODES[_c] = _i
# model 1 class of each char A C G T, model 2 class of each
_Y1 = np.array([5, 2, 4, 3])
_Y2 = np.array([4, 1, 3, 2])


def emission_costs(bases: np.ndarray, l1: np.ndarray, l2: np.ndarray,
                   offset: int):
    """Per window i, the cost of writing, for base b = bases[offset + i]:
    one char c (``one`` [W, 6], by code), b then c (``two`` [W, 6]), nothing
    (``none`` [W]); and b's code [W]."""
    w = len(l1)
    g1 = (l1.max(1, keepdims=True) - l1).astype(np.float32)
    g2 = (l2.max(1, keepdims=True) - l2).astype(np.float32)
    pair = np.maximum(g1[:, :, None], g2[:, None, :])       # [W, 6, 5]
    b = CODES[bases[offset : offset + w]]
    same = pair[:, _Y1, _Y2]                                # y = z = c
    dele = pair[:, 0, _Y2]                                  # y = 'D', z = c
    none = pair[:, 1, 0]                                    # y = z = '-'
    other = pair.copy()
    other[:, _Y1, _Y2] = INF
    other[:, 0, 1:] = INF
    other[:, 1, 0] = INF
    other = other.reshape(w, -1).min(1)                     # writes b
    one = np.full((w, 6), INF, np.float32)
    one[:, :4] = same
    rows = np.arange(w)
    one[rows, b] = np.minimum(one[rows, b], other)
    two = np.full((w, 6), INF, np.float32)
    two[:, :4] = dele
    return one, two, none, b


def widest_gap(items: list, band: int = 16) -> list[float]:
    """``items``: (bases u8, logits of model 1 [W, 6], of model 2 [W, 5],
    offset, written read as bytes). Returns each item's widest gap."""
    res = [float("inf")] * len(items)
    jobs = []
    for n, (bases, l1, l2, off, text) in enumerate(items):
        w = len(l1)
        head, tail = bases[:off].tobytes(), bases[off + w:].tobytes()
        if (len(text) < len(head) + len(tail) or not text.startswith(head)
                or not text.endswith(tail)):
            continue
        mid = np.frombuffer(text[len(head): len(text) - len(tail)], np.uint8)
        if w == 0:
            res[n] = 0.0 if len(mid) == 0 else float("inf")
            continue
        jobs.append((n, w, CODES[mid], emission_costs(bases, l1, l2, off)))
    if not jobs:
        return res
    jobs.sort(key=lambda j: -j[1])
    k, width = band, 2 * band + 1
    ks = np.arange(width) - k
    # the written chars of every job, each padded by band + 2 unmatched codes
    pad = np.full(k + 2, 5, np.int64)
    chars = np.concatenate([np.concatenate([pad, m, pad]) for _, _, m, _ in jobs])
    m_len = np.array([len(m) for _, _, m, _ in jobs])
    m_off = np.concatenate([[0], np.cumsum(m_len + 2 * (k + 2))])[:-1] + k + 2
    one = np.concatenate([c[0] for *_, c in jobs])
    two = np.concatenate([c[1] for *_, c in jobs])
    none = np.concatenate([c[2] for *_, c in jobs])
    base = np.concatenate([c[3] for *_, c in jobs])
    widths = np.array([w for _, w, _, _ in jobs])
    c_off = np.concatenate([[0], np.cumsum(widths)])[:-1]
    value = np.full((len(jobs), width), INF, np.float32)
    value[:, k] = 0.0
    total = value.copy()                       # sums of costs: the centring
    cols = np.arange(width)[None, :]
    centre = np.zeros(len(jobs), np.int64)
    active = len(jobs)
    for i in range(int(widths[0])):
        while widths[active - 1] <= i:
            active -= 1
        v, s, c = value[:active], total[:active], centre[:active]
        j = np.clip(c[:, None] + ks[None, :], -k - 1, m_len[:active, None] + k)
        at = m_off[:active, None] + j
        x1, x2 = chars[at], chars[at + 1]
        pos = c_off[:active] + i
        c0 = none[pos][:, None]
        c1 = one[pos[:, None], x1]
        c2 = np.where(x1 == base[pos][:, None], two[pos[:, None], x2], INF)
        nv = np.full((active, width + 2 + 2 * k), INF, np.float32)
        ns = nv.copy()
        for o, cost in enumerate((c0, c1, c2)):
            sl = slice(k + o, k + o + width)
            np.minimum(nv[:, sl], np.maximum(v, cost), out=nv[:, sl])
            np.minimum(ns[:, sl], s + cost, out=ns[:, sl])
        shift = np.argmin(ns[:, k : k + width + 2], axis=1) - k   # recentre
        c = centre[:active] = c + shift
        at = (shift + k)[:, None] + cols
        past = c[:, None] + ks[None, :] > m_len[:active, None]
        v = np.take_along_axis(nv, at, axis=1)
        v[past] = INF
        value[:active] = v
        s = np.take_along_axis(ns, at, axis=1)
        s[past] = INF
        total[:active] = s
        d = active - 1
        while d >= 0 and widths[d] == i + 1:
            at_end = m_len[d] - centre[d] + k
            if 0 <= at_end < width:
                res[jobs[d][0]] = float(value[d, at_end])
            d -= 1
    return res
