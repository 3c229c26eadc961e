"""Single-read fast5 (HDF5) ingestion with a fully vectorized event decode.

Copy of ``nanoreviser_tpu/io/fast5.py`` (numpy only, with the package's
own HDF5 reader ``io.hdf5``), kept here so the port imports nothing of the
JAX package.

Behavioral contract (parity with the reference implementation,
nanorevutils/nanorev_fast5_handeler.py:39-171):

* Events live at ``/Analyses/<group>/<subgroup>/Events`` as a structured array
  with fields (mean, start, stdv, length, model_state[S5], move, ...).
* If the basecaller ``version`` attribute is missing or <= 0.0, ``start`` and
  ``length`` are in seconds and are rescaled by the 4 kHz sampling rate with
  the raw ``start_time`` subtracted (reference :68-73).
* Per-base emission semantics over events in *forward* order
  (the reference iterates reversed and reverses back — identical result,
  reference :84-118):
    - move == 0: emit nothing
    - move == 1: emit (start,     model_state[2])
    - move == 2: emit (start,     model_state[1]) then (start + 2, model_state[2])
    - move >= 3: emit (start,     model_state[2])
  Each emitted base carries the event's (mean, stdv) as (ab_mean, ab_std).
* Per-base durations are ``diff(start)``; the last duration is 3.0 if
  ``start[-1] - start[-2] < 5`` else 5.0 (reference :120-129).
* The raw signal must be at least ``start[-1] + length[-1]`` samples long
  (checked on absolute starts, reference :142-143).

The reference implements the emission with a per-event Python loop (the
hottest host-side loop in its inference path); here it is O(1) numpy calls,
~100x faster, producing identical outputs (tests/test_fast5.py checks the
empirical invariant decoded == embedded_fastq[2:-2] on all shipped reads).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import hdf5

DEFAULT_BASECALL_GROUP = "Basecall_1D_000"
DEFAULT_BASECALL_SUBGROUP = "BaseCalled_template"
LEGACY_SAMPLING_RATE = 4000


class Fast5Error(RuntimeError):
    """Raised for malformed / unreadable fast5 content."""


@dataclass
class ReadData:
    """Decoded per-read data, mirroring the reference get_read_data tuple."""

    read_start_rel_to_raw: int          # abs sample index of the first base
    starts: np.ndarray                  # int64 [N] base starts rel. to read_start
    lengths: np.ndarray                 # float64 [N] per-base durations
    bases: str                          # decoded base sequence (len N)
    signal: np.ndarray                  # int16 [S] full raw signal
    ab_mean: np.ndarray                 # float32 [N] event means
    ab_std: np.ndarray                  # float32 [N] event stdvs
    mad: tuple | None = None            # optional precomputed (shift, scale)

    @property
    def n_bases(self) -> int:
        return len(self.starts)


def _version_leq_zero(version: object) -> bool:
    """True when the basecaller version parses as <= 0.0 (legacy albacore)."""
    if version is None:
        return True
    text = version.decode() if isinstance(version, bytes) else str(version)
    parts = []
    for tok in text.split("."):
        num = ""
        for ch in tok:
            if ch.isdigit():
                num += ch
            else:
                break
        if not num:
            break
        parts.append(int(num))
    if not parts:
        return True
    return all(p == 0 for p in parts)


def decode_events(
    event_starts: np.ndarray,
    event_moves: np.ndarray,
    event_states: np.ndarray,
    event_means: np.ndarray,
    event_stdvs: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized move-semantics decode of an albacore event table.

    Returns (starts[int64], base_codes[uint8 ascii], ab_mean, ab_std) in
    forward order, matching the reference's reverse-iterate-then-reverse loop.
    """
    moves = np.asarray(event_moves)
    starts = np.asarray(event_starts).astype(np.int64)
    # emissions per event: move==0 -> 0, move==2 -> 2, else 1
    counts = np.where(moves == 0, 0, np.where(moves == 2, 2, 1)).astype(np.int64)
    total = int(counts.sum())
    if total < 2:
        raise Fast5Error("Events is too short or there are too much zero moves.")

    ev_idx = np.repeat(np.arange(len(moves), dtype=np.int64), counts)
    first_slot = np.cumsum(counts) - counts          # output offset of each event
    pos_in_event = np.arange(total, dtype=np.int64) - first_slot[ev_idx]

    is_double = moves[ev_idx] == 2
    second_of_pair = is_double & (pos_in_event == 1)
    first_of_pair = is_double & (pos_in_event == 0)

    out_starts = starts[ev_idx] + np.where(second_of_pair, 2, 0)

    # model_state is S5; view each 5-mer as 5 raw bytes
    states = np.ascontiguousarray(np.asarray(event_states))
    state_bytes = states.view("S1").reshape(len(states), -1).view(np.uint8)
    char_idx = np.where(first_of_pair, 1, 2)
    out_bases = state_bytes[ev_idx, char_idx]

    out_mean = np.asarray(event_means)[ev_idx]
    out_std = np.asarray(event_stdvs)[ev_idx]
    return out_starts, out_bases, out_mean, out_std


def base_durations(abs_starts: np.ndarray) -> np.ndarray:
    """Per-base durations: diff of starts plus the reference's 3/5 tail rule."""
    lengths = np.diff(abs_starts).astype(np.float64)
    tail = 3.0 if (abs_starts[-1] - abs_starts[-2]) < 5 else 5.0
    return np.concatenate([lengths, [tail]])


def get_read_data(
    fast5_fn: str | os.PathLike,
    basecall_group: str = DEFAULT_BASECALL_GROUP,
    basecall_subgroup: str = DEFAULT_BASECALL_SUBGROUP,
) -> ReadData:
    """Decode one single-read fast5 into per-base arrays (vectorized)."""
    try:
        f = hdf5.File(fast5_fn, "r")
    except Exception as exc:  # noqa: BLE001
        raise Fast5Error("Error opening file. Likely a corrupted file.") from exc

    with f:
        try:
            group = f["/Analyses/" + basecall_group]
            version = group.attrs.get("version", None)
            events = f[
                "/Analyses/" + basecall_group + "/" + basecall_subgroup + "/Events"
            ][()]
            ev_starts = events["start"].astype(np.float64)
            ev_lengths = events["length"].astype(np.float64)
            if _version_leq_zero(version):
                raw_grp = list(f["/Raw/Reads/"].values())[0]
                start_time = float(raw_grp.attrs["start_time"])
                ev_starts = ev_starts * LEGACY_SAMPLING_RATE - start_time
                ev_lengths = ev_lengths * LEGACY_SAMPLING_RATE
        except Fast5Error:
            raise
        except Exception as exc:  # noqa: BLE001
            raise Fast5Error(
                "No events or corrupted events in file. Likely a segmentation error."
            ) from exc

        out_starts, out_base_codes, ab_mean, ab_std = decode_events(
            ev_starts, events["move"], events["model_state"],
            events["mean"], events["stdv"],
        )
        lengths = base_durations(out_starts)

        try:
            read_name = list(f["/Raw/Reads/"].items())[0][0]
            signal = f["/Raw/Reads/" + str(read_name) + "/Signal"][()]
        except Exception as exc:  # noqa: BLE001
            raise Fast5Error("No signal stored in the file") from exc

    if len(signal) < int(out_starts[-1] + lengths[-1]):
        raise Fast5Error("Signal is shorter than the Events")

    abs_event_start = int(out_starts[0])
    return ReadData(
        read_start_rel_to_raw=abs_event_start,
        starts=out_starts - abs_event_start,
        lengths=lengths,
        bases=out_base_codes.tobytes().decode("ascii"),
        signal=signal,
        ab_mean=ab_mean,
        ab_std=ab_std,
    )


def extract_fastq(
    fast5_fn: str | os.PathLike,
    basecall_group: str = DEFAULT_BASECALL_GROUP,
    basecall_subgroup: str = DEFAULT_BASECALL_SUBGROUP,
    trim: int = 7,
) -> tuple[str, str]:
    """Embedded-fastq extraction, trimmed by ``trim`` bases at both ends.

    Parity: reference nanorev_fast5_handeler.py:152-171 (returns
    bases[7:-7], qual[7:-7]).
    """
    try:
        with hdf5.File(fast5_fn, "r") as f:
            fastq = f[
                "/Analyses/" + basecall_group + "/" + basecall_subgroup + "/Fastq"
            ][()]
    except Exception as exc:  # noqa: BLE001
        raise Fast5Error("Error opening file. Likely a corrupted file.") from exc
    lines = fastq.decode("utf8").split("\n")
    bases, qual = lines[1], lines[3]
    if len(bases) < 2 * trim or len(bases) != len(qual):
        raise Fast5Error("Embedded fastq too short or malformed.")
    return bases[trim:-trim], qual[trim:-trim]


def list_fast5_files(fast5_dir: str | os.PathLike) -> list[str]:
    """All entries of a directory, sorted for deterministic sharding."""
    return sorted(
        fn for fn in os.listdir(fast5_dir)
        if os.path.isfile(os.path.join(fast5_dir, fn))
    )
