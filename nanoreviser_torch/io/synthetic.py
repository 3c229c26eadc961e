"""Synthetic single-read fast5 files for tests and the chip smoke.

Writes the layout ``io.fast5.get_read_data`` and ``extract_fastq`` read:

* ``/Analyses/Basecall_1D_000`` with a ``version`` attribute above 0 (event
  starts and lengths in samples, not the legacy seconds);
* ``.../BaseCalled_template/Events``: a compound array with ``start``,
  ``length``, ``mean``, ``stdv``, ``model_state`` (S5) and ``move`` in
  {0, 1, 2}, consistent with the decoded bases (``model_state[2]`` is the
  last base an event emits, ``[1]`` the first of a move-2 pair);
* ``.../BaseCalled_template/Fastq``: the basecall with 7 extra bases at
  each end (``extract_fastq`` trims them);
* ``/Raw/Reads/Read_<n>/Signal``: int16 around 450 +- 40, with a
  ``start_time`` attribute.

With ``compression="gzip"`` the Events are stored in chunks of 256 rows
and the Signal in chunks of 8,192 samples, each shuffled and deflated at
zlib level 4 (h5py's default). Real single-read fast5 files are commonly
stored chunked and gzip-compressed; no such file is in the repository, so
these stand in for them where the ingest is tested and timed.

Events sit about 9 samples apart (4 kHz at 450 bases/s); about one event in
60 stalls for 60-200 samples, ~0.3% of samples spike by 150-400 and ~0.2%
of calls are 'N', so that compaction and every escape list of the wire
format (signal, vlen, duration, color) are exercised.
"""

from __future__ import annotations

import os

import numpy as np

from . import hdf5

EVENT_DTYPE = np.dtype([
    ("start", "<u8"), ("length", "<u8"), ("mean", "<f4"), ("stdv", "<f4"),
    ("model_state", "S5"), ("move", "<i4"),
])


def synthetic_read_arrays(n_bases: int, rng: np.random.Generator):
    """(bases, events, signal, fastq_bases, fastq_qual) for one read."""
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), n_bases)
    bases[rng.random(n_bases) < 0.002] = ord("N")   # non-ACGT calls, rare
    moves = []
    emitted = 0
    while emitted < n_bases:
        u = rng.random()
        if u < 0.05:
            mv = 0
        elif u < 0.12 and emitted + 2 <= n_bases:
            mv = 2
        else:
            mv = 1
        moves.append(mv)
        emitted += mv
    moves = np.asarray(moves, np.int32)
    n_ev = len(moves)
    lengths = rng.integers(6, 13, n_ev).astype(np.int64)
    stall = rng.random(n_ev) < 1.0 / 60
    lengths[stall] = rng.integers(60, 200, int(stall.sum()))
    lengths[moves == 2] = np.maximum(lengths[moves == 2], 4)
    head = int(rng.integers(200, 800))
    starts = head + np.concatenate([[0], np.cumsum(lengths[:-1])])
    total = int(starts[-1] + lengths[-1]) + int(rng.integers(100, 400))

    # model_state of an event: the 5-mer centred on the last base it emits
    padded = np.concatenate([np.full(2, ord("A"), np.uint8), bases,
                             np.full(2, ord("A"), np.uint8)])
    last = np.maximum(np.cumsum(moves) - 1, 0)
    kmers = np.stack([padded[last + k] for k in range(5)], axis=1)
    states = np.frombuffer(kmers.tobytes(), "S5")

    levels = rng.integers(410, 491, n_ev).astype(np.float64)
    signal = np.empty(total, np.float64)
    signal[:head] = rng.normal(450.0, 12.0, head)
    for k in range(n_ev):
        s, ln = int(starts[k]), int(lengths[k])
        signal[s : s + ln] = rng.normal(levels[k], 4.0, ln)
    tail_start = int(starts[-1] + lengths[-1])
    signal[tail_start:] = rng.normal(450.0, 12.0, total - tail_start)
    # rare spikes: deltas beyond the wire format's 8-bit zig-zag range
    spikes = rng.random(total) < 0.003
    signal[spikes] += rng.choice([-1.0, 1.0], int(spikes.sum())) * rng.integers(
        150, 400, int(spikes.sum()))
    signal = np.clip(np.rint(signal), -32768, 32767).astype(np.int16)

    events = np.zeros(n_ev, EVENT_DTYPE)
    events["start"] = starts
    events["length"] = lengths
    events["mean"] = [signal[s : s + ln].mean() for s, ln in zip(starts, lengths)]
    events["stdv"] = [signal[s : s + ln].std() for s, ln in zip(starts, lengths)]
    events["model_state"] = states
    events["move"] = moves

    flank = rng.choice(np.frombuffer(b"ACGT", np.uint8), 14)
    fq_bases = (flank[:7].tobytes() + bases.tobytes() + flank[7:].tobytes()).decode()
    fq_qual = bytes(rng.integers(33 + 5, 33 + 30, len(fq_bases)).astype(np.uint8)).decode()
    return bases.tobytes().decode(), events, signal, fq_bases, fq_qual


def write_synthetic_fast5(path: str | os.PathLike, n_bases: int,
                          rng: np.random.Generator, read_number: int = 1,
                          compression: str | None = None) -> str:
    """Write one synthetic read; returns its decoded base sequence.
    ``compression``: None (contiguous datasets) or "gzip" (chunked)."""
    bases, events, signal, fq_bases, fq_qual = synthetic_read_arrays(n_bases, rng)
    gz = {} if compression is None else {"compression": compression, "shuffle": True}
    group = "/Analyses/Basecall_1D_000"
    sub = group + "/BaseCalled_template"
    with hdf5.File(path, "w") as f:
        g = f.create_group(group)
        g.attrs["version"] = "2.3.1"
        s = f.create_group(sub)
        s.create_dataset("Events", data=events, chunks=(256,) if gz else None, **gz)
        fastq = f"@read_{read_number}\n{fq_bases}\n+\n{fq_qual}\n"
        s.create_dataset("Fastq", data=np.bytes_(fastq.encode()))
        r = f.create_group(f"/Raw/Reads/Read_{read_number}")
        r.attrs["start_time"] = np.uint64(1000 * read_number)
        r.attrs["read_number"] = np.int32(read_number)
        r.create_dataset("Signal", data=signal, chunks=(8192,) if gz else None, **gz)
    return bases


def write_synthetic_dir(out_dir: str | os.PathLike, n_reads: int, n_bases,
                        seed: int, compression: str | None = None) -> list[str]:
    """``n_reads`` files ``read_<k>.fast5`` in ``out_dir``; ``n_bases`` is an
    int or a (low, high) range; ``compression`` as in
    ``write_synthetic_fast5`` (one seed gives the same reads either way).
    Returns the file names, sorted."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for k in range(n_reads):
        n = n_bases if isinstance(n_bases, int) else int(rng.integers(*n_bases))
        name = f"read_{k:04d}.fast5"
        write_synthetic_fast5(os.path.join(out_dir, name), n, rng, k + 1,
                              compression)
        names.append(name)
    return names
