"""The judge: its banded search against an exhaustive one, reads the
reference writes itself, labels flipped on purpose, drift."""

import numpy as np
import pytest

from portbench.judge import CODES, emission_costs, widest_gap
from portbench.reference.reviser import merge


def exhaustive(bases, l1, l2, off, text):
    """The same smallest largest cost over every position in the written
    read, no band."""
    w = len(l1)
    head, tail = bases[:off].tobytes(), bases[off + w:].tobytes()
    if not (text.startswith(head) and text.endswith(tail)):
        return np.inf
    mid = CODES[np.frombuffer(text[len(head): len(text) - len(tail)], np.uint8)]
    one, two, none, b = emission_costs(bases, l1, l2, off)
    n = len(mid)
    v = np.full(n + 1, np.inf)
    v[0] = 0.0
    for i in range(w):
        nxt = np.maximum(v, none[i])
        for j in range(n + 1):
            if j < n:
                nxt[j + 1] = min(nxt[j + 1], max(v[j], one[i, mid[j]]))
            if j + 1 < n and mid[j] == b[i]:
                nxt[j + 2] = min(nxt[j + 2], max(v[j], two[i, mid[j + 1]]))
        v = nxt
    return v[n]


def case(rng, n, t=11, flip=0.0):
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n,
                       p=[0.249, 0.249, 0.249, 0.249, 0.004])
    w = max(n - t, 0)
    l1 = rng.normal(0, 1, (w, 6)).astype(np.float32)
    l2 = rng.normal(0, 1, (w, 5)).astype(np.float32)
    y1 = l1.argmax(1)
    second = np.argsort(-l1, 1)[:, 1]
    flipped = rng.random(w) < flip
    y1 = np.where(flipped, second, y1)
    cost = float((l1.max(1) - l1[np.arange(w), y1]).max()) if w else 0.0
    return bases, l1, l2, y1, cost


@pytest.mark.parametrize("seed", range(6))
def test_banded_equals_exhaustive(seed):
    rng = np.random.default_rng(seed)
    items, want = [], []
    for _ in range(5):
        n = int(rng.integers(12, 160))
        bases, l1, l2, y1, _ = case(rng, n, flip=0.1)
        off = int(rng.integers(0, 12))
        text = merge(bases, y1, l2.argmax(1), off)
        if rng.random() < 0.3:                      # a char changed
            t = bytearray(text)
            t[int(rng.integers(0, len(t)))] = ord("G")
            text = bytes(t)
        items.append((bases, l1, l2, off, text))
        want.append(exhaustive(bases, l1, l2, off, text))
    np.testing.assert_allclose(widest_gap(items), want)


def test_reference_reads_need_nothing_and_flips_their_cost():
    rng = np.random.default_rng(7)
    items, costs = [], []
    for n in (11, 12, 500, 3000, 9000):
        bases, l1, l2, y1, cost = case(rng, n, flip=0.004)
        items.append((bases, l1, l2, 5, merge(bases, l1.argmax(1), l2.argmax(1), 5)))
        items.append((bases, l1, l2, 5, merge(bases, y1, l2.argmax(1), 5)))
        costs.append(cost)
    got = widest_gap(items)
    assert got[0::2] == [0.0] * 5
    assert all(g <= c + 1e-6 for g, c in zip(got[1::2], costs))


def test_follows_a_drifting_read():
    """Labels that drop many bases on near ties: the written read ends up far
    shorter than the reference's, and the judge still follows it."""
    rng = np.random.default_rng(3)
    n = 4000
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    w = n - 11
    l1 = rng.normal(0, 1, (w, 6)).astype(np.float32)
    l2 = rng.normal(0, 1, (w, 5)).astype(np.float32)
    l1[:, 1] = l1.max(1) - 0.01 * (l1.argmax(1) != 1)     # '-' a near tie
    l2[:, 0] = l2.max(1) - 0.01 * (l2.argmax(1) != 0)
    drop = np.arange(w) % 10 == 0                           # 398 bases dropped
    y1 = np.where(drop, 1, l1.argmax(1))
    y2 = np.where(drop, 0, l2.argmax(1))
    text = merge(bases, y1, y2, 5)
    ref_text = merge(bases, l1.argmax(1), l2.argmax(1), 5)
    assert len(ref_text) - len(text) > 300
    assert widest_gap([(bases, l1, l2, 5, text)])[0] == pytest.approx(0.01, abs=1e-6)


def test_unexplainable_reads():
    rng = np.random.default_rng(5)
    bases, l1, l2, _, _ = case(rng, 300)
    text = merge(bases, l1.argmax(1), l2.argmax(1), 5)
    assert widest_gap([(bases, l1, l2, 5, b"X" + text[1:])]) == [np.inf]   # head
    assert widest_gap([(bases, l1, l2, 5, text[:-1])]) == [np.inf]         # tail
    assert widest_gap([(bases, l1, l2, 5, text + text)]) == [np.inf]
