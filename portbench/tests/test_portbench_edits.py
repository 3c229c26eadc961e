"""``portbench.edits``: the anchored distance against a full Levenshtein
table, on reads that differ in a few places, on the tandem repeats a
model with random weights writes, and on reads far apart."""

import numpy as np
import pytest

from portbench import edits


def levenshtein(a: bytes, b: bytes) -> int:
    """The full table, one row at a time."""
    x, y = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    j = np.arange(len(y) + 1)
    row = j.copy()
    for i in range(1, len(x) + 1):
        t = np.empty_like(row)
        t[0] = i
        t[1:] = np.minimum(row[1:] + 1, row[:-1] + (y != x[i - 1]))
        row = np.minimum.accumulate(t - j) + j
    return int(row[-1])


def acgt(n: int, rng) -> bytes:
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()


def mutate(a: bytes, n: int, rng) -> bytes:
    s = bytearray(a)
    for _ in range(n):
        at = int(rng.integers(0, len(s)))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            s[at] = acgt(1, rng)[0]
        elif kind == 1:
            del s[at]
        else:
            s.insert(at, acgt(1, rng)[0])
    return bytes(s)


def tandem(n: int, rng) -> bytes:
    """Three short units in a random order: every 32-byte run recurs every
    few dozen bytes, as in what a model with random weights writes."""
    units = [acgt(int(rng.integers(7, 12)), rng) for _ in range(3)]
    out = bytearray()
    while len(out) < n:
        out += units[int(rng.integers(0, 3))]
    return bytes(out[:n])


@pytest.mark.parametrize("kind", ["random", "tandem"])
@pytest.mark.parametrize("n_edits", [0, 3, 40])
def test_distance_is_exact_on_close_reads(kind, n_edits):
    rng = np.random.default_rng(n_edits + (100 if kind == "tandem" else 0))
    pairs = []
    for n in (150, 2700, 9000):
        a = acgt(n, rng) if kind == "random" else tandem(n, rng)
        pairs.append((a, mutate(a, n_edits * n // 2700, rng)))
    assert edits.distances(pairs) == [levenshtein(a, b) for a, b in pairs]


def test_distance_is_never_below_the_truth_on_far_reads():
    rng = np.random.default_rng(7)
    pairs = []
    for n in (400, 1600):
        a = tandem(n, rng)
        pairs.append((a, mutate(a, n // 3, rng)))
    for got, (a, b) in zip(edits.distances(pairs), pairs):
        assert got >= levenshtein(a, b)
