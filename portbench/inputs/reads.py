"""Synthetic single-read fast5 files from a seed: the benchmark's own,
vectorised copy of ``nanoreviser_torch/io/synthetic.py``'s reads.

Same file layout as the program's writer (what Albacore writes and
``io.fast5.get_read_data`` reads): ``/Analyses/Basecall_1D_000`` with a
``version`` above 0 (event starts in samples), its
``BaseCalled_template/Events`` compound table (``start``, ``length``,
``mean``, ``stdv``, ``model_state`` S5, ``move`` in {0, 1, 2}) and
``Fastq`` (the basecall with 7 extra bases at each end), and
``/Raw/Reads/Read_<n>/Signal`` (int16) with ``start_time`` and
``read_number`` attributes. The same statistics: events ~9 samples apart,
one in 60 stalls for 60-200 samples, 0.3% of samples spike by 150-400,
0.2% of calls are 'N', so that the program's compaction and every escape
list of its wire format are exercised.

Read lengths are a fixed stratified sample of a log-normal: the n lengths
at the quantiles (k + 0.5) / n, clipped. Every seed gets the same set of
lengths; the seed picks the bases, the signals and the order.
"""

from __future__ import annotations

import math
import os
import statistics
from dataclasses import dataclass

import numpy as np

from .hdf5w import File

EVENT_DTYPE = np.dtype([
    ("start", "<u8"), ("length", "<u8"), ("mean", "<f4"), ("stdv", "<f4"),
    ("model_state", "S5"), ("move", "<i4"),
])
ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Read:
    """The arrays of one read, as written (the reference reads these)."""

    bases: str
    events: np.ndarray      # EVENT_DTYPE
    signal: np.ndarray      # int16, the whole raw signal


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """The n lengths at the log-normal's quantiles (k + 0.5) / n, clipped to
    [lo, hi], in ascending order."""
    z = np.array([statistics.NormalDist().inv_cdf((k + 0.5) / n)
                  for k in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def read_arrays(n_bases: int, rng: np.random.Generator) -> Read:
    """One synthetic read of ``n_bases`` decoded bases."""
    bases = rng.choice(ACGT, n_bases)
    bases[rng.random(n_bases) < 0.002] = ord("N")   # non-ACGT calls, rare
    # moves: 0 with p 0.05, 2 with p 0.07, else 1, until n_bases are emitted;
    # a last move of 2 that would overshoot becomes 1
    u = rng.random(int(n_bases * 1.2) + 64)
    moves = np.where(u < 0.05, 0, np.where(u < 0.12, 2, 1)).astype(np.int32)
    emitted = np.cumsum(moves)
    n_ev = int(np.searchsorted(emitted, n_bases)) + 1
    moves = moves[:n_ev]
    if emitted[n_ev - 1] > n_bases:
        moves[-1] = 1
    lengths = rng.integers(6, 13, n_ev).astype(np.int64)
    stall = rng.random(n_ev) < 1.0 / 60
    lengths[stall] = rng.integers(60, 200, int(stall.sum()))
    head = int(rng.integers(200, 800))
    starts = head + np.concatenate([[0], np.cumsum(lengths[:-1])])
    end = int(starts[-1] + lengths[-1])
    total = end + int(rng.integers(100, 400))

    # model_state of an event: the 5-mer centred on the last base it emits
    padded = np.concatenate([np.full(2, ord("A"), np.uint8), bases,
                             np.full(2, ord("A"), np.uint8)])
    last = np.maximum(np.cumsum(moves) - 1, 0)
    kmers = np.stack([padded[last + k] for k in range(5)], axis=1)
    states = np.frombuffer(np.ascontiguousarray(kmers).tobytes(), "S5")

    levels = rng.integers(410, 491, n_ev).astype(np.float64)
    signal = np.empty(total, np.float64)
    signal[:head] = rng.normal(450.0, 12.0, head)
    signal[head:end] = np.repeat(levels, lengths) + rng.normal(0.0, 4.0, end - head)
    signal[end:] = rng.normal(450.0, 12.0, total - end)
    # rare spikes: deltas beyond the wire format's 8-bit zig-zag range
    spikes = rng.random(total) < 0.003
    signal[spikes] += rng.choice([-1.0, 1.0], int(spikes.sum())) * rng.integers(
        150, 400, int(spikes.sum()))
    signal = np.clip(np.rint(signal), -32768, 32767).astype(np.int16)

    x = signal[head:end].astype(np.float64)
    cuts = starts - head
    cnt = lengths.astype(np.float64)
    mean = np.add.reduceat(x, cuts) / cnt
    var = np.maximum(np.add.reduceat(x * x, cuts) / cnt - mean * mean, 0.0)
    events = np.zeros(n_ev, EVENT_DTYPE)
    events["start"] = starts
    events["length"] = lengths
    events["mean"] = mean
    events["stdv"] = np.sqrt(var)
    events["model_state"] = states
    events["move"] = moves
    return Read(bases=bases.tobytes().decode(), events=events, signal=signal)


def write_fast5(path: str, read: Read, read_number: int,
                rng: np.random.Generator) -> None:
    group = "/Analyses/Basecall_1D_000"
    flank = rng.choice(ACGT, 14).tobytes().decode()
    fq_bases = flank[:7] + read.bases + flank[7:]
    fq_qual = bytes(rng.integers(38, 63, len(fq_bases)).astype(np.uint8)).decode()
    with File(path) as f:
        g = f.create_group(group)
        g.attrs["version"] = "2.3.1"
        s = f.create_group(group + "/BaseCalled_template")
        s.create_dataset("Events", read.events)
        s.create_dataset("Fastq", np.bytes_(
            f"@read_{read_number}\n{fq_bases}\n+\n{fq_qual}\n".encode()))
        r = f.create_group(f"/Raw/Reads/Read_{read_number}")
        r.attrs["start_time"] = np.uint64(1000 * read_number)
        r.attrs["read_number"] = np.int32(read_number)
        r.create_dataset("Signal", read.signal)


def make_reads(out_dir: str, lengths, seed: int) -> tuple[list[str], list[Read]]:
    """One fast5 per length, ``distinct_<k>.fast5`` in ``out_dir``, read k
    of length ``lengths[k]``. Returns (file names, reads)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng([seed, 1])
    names, reads = [], []
    for k, n in enumerate(lengths):
        read = read_arrays(int(n), rng)
        name = f"distinct_{k:03d}.fast5"
        write_fast5(os.path.join(out_dir, name), read, k + 1, rng)
        names.append(name)
        reads.append(read)
    return names, reads


def link_dir(out_dir: str, targets: list[str], copies: list[int],
             seed: int) -> dict:
    """``sum(copies)`` hard links in ``out_dir``, ``copies[k]`` of them to
    ``targets[k]``, under random 16-hex-digit names from the seed (so the
    program's sorted order mixes the targets). Hard links, not symbolic
    ones: each name is a regular file, as in a real folder, and opening it
    walks one path. Returns {link name: k}."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng([seed, 2])
    which = np.repeat(np.arange(len(targets)), copies)
    rng.shuffle(which)
    names: dict = {}
    while len(names) < len(which):
        draw = rng.integers(0, 2 ** 63, len(which) - len(names), dtype=np.int64)
        for v in draw:
            names.setdefault(f"{int(v):016x}.fast5", None)
    out = {}
    for name, k in zip(names, which):
        os.link(targets[k], os.path.join(out_dir, name))
        out[name] = int(k)
    return out


def copies_per_read(n_links: int, n_reads: int) -> list[int]:
    """``n_links`` spread over ``n_reads`` as evenly as possible; the extra
    links go to every other read by length rank, so the work does not
    depend on the seed."""
    base, extra = divmod(n_links, n_reads)
    step = n_reads / extra if extra else 0
    bonus = {int(math.floor(i * step)) for i in range(extra)}
    return [base + (k in bonus) for k in range(n_reads)]
