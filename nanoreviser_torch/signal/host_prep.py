"""Per-read host preparation: the windowed prep, the compaction and the
prep pool's worker entry points (counterpart of
``nanoreviser_tpu/signal/host_prep.py``).

The windowed prep gathers each base's raw 50-sample window on the host
(``PreppedRead.win``, int16) for the pre-gathered-window path
(``signal.device_prep`` -> ``models.fused.signal_branch_apply`` ->
``ops.reviser_kernel.stack_logits_multi``). The compacted prep is what the
streaming engine uploads: each read's raw int16 signal is compacted to the
union of its per-base window intervals (gaps wider than the 50-sample
window, i.e. translocation stalls, are dropped), giving ~10 samples per base
plus per-base gather starts, valid lengths and f16 features. ``infer.wire``
byte-packs the result.
After compaction consecutive window starts differ by at most 50 samples.

Behavioral contract (reference preprocessing.py:85-170,
nanorevtrainutils.py:160-169):

* window [st-25, st+25) clamped to the signal tail, zero-padded with the
  reference's symmetric split (left = ceil(pad/2)); the zeroing happens
  after normalization, via the per-row valid length;
* event moments are exact int64 prefix-sum population moments over
  [st, next_st) (last base: the 3/5-rule duration), in f64;
* the 6 feature columns are [color/300, ev_mean/shift, ev_std/scale,
  duration/10, ab_mean, ab_std], rounded once from f64 to f16.

``prep_read`` and ``compact_read`` run the host library (``native``,
C++, bit-exact with the numpy functions; the windowed prep's pad columns
are zero there), and ``compact_fast5`` decodes and compacts a file in one
library call (``nr_fast5_compact``, bit-exact with
``compact_read(get_read_data(path))``). A read the library refuses for a
reason other than the size of the caller's buffers is run again on the
Python path, which raises the package's own error for a bad read;
``native_fallbacks`` counts the reads in this process that the Python path
read after the library refused them.

This module and everything it imports stay free of torch: the prep pool's
``spawn`` workers (``infer.hostpipe``) import it.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np

from .. import native
from ..io import hdf5
from ..io.fast5 import Fast5Error, ReadData, get_read_data
from .features import BASE_COLOR_TABLE, ascii_codes
from .segmentation import mad_normalizers_int16

QUERY_LEN = 50

_native_fallbacks = 0


def native_fallbacks() -> int:
    """Reads this process ran again on the Python path (``io.hdf5``, numpy)
    after the host library refused them (a retry with larger buffers is not
    counted)."""
    return _native_fallbacks


def _fall_back(exc: Exception) -> None:
    global _native_fallbacks
    _native_fallbacks += 1
    if _native_fallbacks == 1:
        logging.getLogger("nanoreviser_torch").warning(
            "host library refused a read (%s); running it on the Python path",
            exc)


@dataclass
class PreppedRead:
    """Everything the pre-gathered-window path needs from one read."""

    bases: str
    win: np.ndarray        # [N, QUERY_LEN] int16 raw DAC (padding masked later)
    vlen: np.ndarray       # [N] uint8 valid window length (left pad derived)
    feats: np.ndarray      # [N, 6] float16 final per-base features
    shift: float           # per-read median (raw DAC units)
    scale: float           # per-read MAD

    @property
    def n_bases(self) -> int:
        return len(self.vlen)


def prep_read(rd: ReadData, query_len: int = QUERY_LEN,
              out: tuple | None = None) -> PreppedRead:
    """ReadData -> PreppedRead by the host library (``nr_prep_read``).

    ``out``: (win, vlen, feats) arrays of at least N rows to fill in place;
    a read larger than them is prepped into new arrays."""
    tail = rd.signal[rd.read_start_rel_to_raw :]
    try:
        win, vlen, feats, shift, scale = native.prep_read_native_arrays(
            tail, rd.starts, rd.bases, rd.lengths, rd.ab_mean, rd.ab_std,
            query_len, mad=rd.mad, out=out)
    except native.NativeError as exc:
        if exc.rc == native.CAPACITY and out is not None:
            return prep_read(rd, query_len)
        _fall_back(exc)
        return prep_read_numpy(rd, query_len)
    return PreppedRead(bases=rd.bases, win=win, vlen=vlen, feats=feats,
                       shift=shift, scale=scale)


def prep_read_numpy(rd: ReadData, query_len: int = QUERY_LEN) -> PreppedRead:
    """ReadData -> PreppedRead, vectorized numpy (int32 index math; the tail
    is edge-padded so the window gather needs no clip)."""
    tail = rd.signal[rd.read_start_rel_to_raw :]
    if not tail.flags.c_contiguous:
        tail = np.ascontiguousarray(tail)
    if rd.mad is not None:
        shift, scale = rd.mad
    else:
        shift, scale = mad_normalizers_int16(tail)
    n_samples = len(tail)
    starts = np.asarray(rd.starts, np.int32)

    ahead = query_len // 2
    win_st = np.maximum(starts - ahead, 0)
    win_en = np.minimum(starts + (query_len - ahead), n_samples)
    vlen = win_en - win_st
    left = (query_len - vlen + 1) // 2

    # gather positions range over [-q, n_samples + q); pad the tail by q on
    # both sides so no clip pass is needed (out-of-range cols are masked
    # after normalization via vlen anyway)
    padded = np.empty(n_samples + 2 * query_len, np.int16)
    padded[:query_len] = 0
    padded[query_len : query_len + n_samples] = tail
    padded[query_len + n_samples :] = 0
    cols = np.arange(query_len, dtype=np.int32)
    pos = (win_st - left + query_len)[:, None] + cols[None, :]
    win = padded[pos]

    mean, std = _event_moments(tail, starts, rd.lengths)
    feats = _features_f16(rd, mean, std, shift, scale)
    return PreppedRead(
        bases=rd.bases,
        win=np.ascontiguousarray(win, dtype=np.int16),
        vlen=vlen.astype(np.uint8),
        feats=feats,
        shift=float(shift),
        scale=float(scale),
    )


def prep_fast5(
    path: str,
    basecall_group: str = "Basecall_1D_000",
    basecall_subgroup: str = "BaseCalled_template",
) -> PreppedRead:
    """Decode + prep one fast5."""
    return prep_read(get_read_data(path, basecall_group, basecall_subgroup))


def _event_moments(tail: np.ndarray, starts: np.ndarray, lengths):
    """Exact prefix-sum event moments over [st, next_st); the last base
    spans its 3/5-rule duration, clamped to the tail. Squares fit int32
    (|DAC| < 2^15), accumulation is int64."""
    n_samples = len(tail)
    n = len(starts)
    last_dur = int(lengths[-1])
    ends = np.empty(n, np.int32)
    ends[:-1] = starts[1:]
    ends[-1] = min(starts[-1] + last_dur, n_samples)
    sig_i32 = tail.astype(np.int32)
    csum = np.empty(n_samples + 1, np.int64)
    csum[0] = 0
    np.cumsum(sig_i32, dtype=np.int64, out=csum[1:])
    csum2 = np.empty(n_samples + 1, np.int64)
    csum2[0] = 0
    np.cumsum(sig_i32 * sig_i32, dtype=np.int64, out=csum2[1:])
    cnt = np.maximum((ends - starts).astype(np.float64), 1.0)
    ssum = (csum[ends] - csum[starts]).astype(np.float64)
    ssum2 = (csum2[ends] - csum2[starts]).astype(np.float64)
    mean = ssum / cnt
    std = np.sqrt(np.maximum(ssum2 / cnt - mean * mean, 0.0))
    return mean, std


def _features_f16(rd: ReadData, mean, std, shift, scale) -> np.ndarray:
    """The 6 feature columns, rounded once from f64 to f16."""
    feats = np.empty((len(mean), 6), np.float16)
    feats[:, 0] = BASE_COLOR_TABLE[ascii_codes(rd.bases)] * (1.0 / 300.0)
    feats[:, 1] = mean / shift
    feats[:, 2] = std / scale
    feats[:, 3] = np.asarray(rd.lengths, np.float64) * 0.1
    feats[:, 4] = rd.ab_mean
    feats[:, 5] = rd.ab_std
    return feats


@dataclass
class CompactRead:
    """Everything the device batch needs from one read, compacted."""

    bases: str
    csig: np.ndarray       # [M] int16 compacted signal (window-interval union)
    pos0: np.ndarray       # [N] int32 window gather start in csig space
                           #     (= window start - left pad; may be -25..)
    vlen: np.ndarray       # [N] uint8 valid window length
    feats: np.ndarray      # [N, 6] float16 final per-base features
    shift: float           # per-read median (raw DAC units)
    scale: float           # per-read MAD

    @property
    def n_bases(self) -> int:
        return len(self.vlen)

    @property
    def n_samples(self) -> int:
        return len(self.csig)


def compact_read_numpy(rd: ReadData, query_len: int = QUERY_LEN) -> CompactRead:
    """Vectorized numpy compaction + exact f64 moments + f16 features.

    The compacted buffer concatenates the maximal merged runs of overlapping
    window intervals; every window maps to a contiguous [cst, cst+vlen)
    slice of it.
    """
    tail = rd.signal[rd.read_start_rel_to_raw :]
    if not tail.flags.c_contiguous:
        tail = np.ascontiguousarray(tail)
    if rd.mad is not None:
        shift, scale = rd.mad
    else:
        shift, scale = mad_normalizers_int16(tail)
    n_samples = len(tail)
    starts = np.asarray(rd.starts, np.int32)
    n = len(starts)

    ahead = query_len // 2
    win_st = np.maximum(starts - ahead, 0)
    win_en = np.minimum(starts + (query_len - ahead), n_samples)
    vlen = (win_en - win_st).astype(np.uint8)
    left = (query_len - vlen.astype(np.int32) + 1) // 2

    # maximal merged interval runs (window starts/ends are non-decreasing)
    brk = np.flatnonzero(win_st[1:] > win_en[:-1])
    first_idx = np.concatenate([[0], brk + 1])
    last_idx = np.concatenate([brk, [n - 1]])
    ist = win_st[first_idx]
    ien = win_en[last_idx]
    clen = ien - ist
    coff = np.concatenate([[0], np.cumsum(clen[:-1], dtype=np.int64)])
    m_total = int(coff[-1] + clen[-1])

    iid = np.zeros(n, np.int64)
    iid[brk + 1] = 1
    np.cumsum(iid, out=iid)
    cst = win_st.astype(np.int64) - ist[iid] + coff[iid]
    pos0 = (cst - left).astype(np.int32)

    csig = np.empty(m_total, np.int16)
    for k in range(len(first_idx)):
        o = coff[k]
        csig[o : o + clen[k]] = tail[ist[k] : ien[k]]

    mean, std = _event_moments(tail, starts, rd.lengths)
    feats = _features_f16(rd, mean, std, shift, scale)
    return CompactRead(
        bases=rd.bases, csig=csig, pos0=pos0, vlen=vlen, feats=feats,
        shift=float(shift), scale=float(scale),
    )


def compact_read(rd: ReadData, query_len: int = QUERY_LEN,
                 out: tuple | None = None) -> CompactRead:
    """ReadData -> CompactRead by the host library (``nr_compact_read``).

    ``out``: (csig, pos0, vlen, feats) arrays to fill in place (csig's
    length is the sample capacity); a read larger than them is compacted
    into new arrays."""
    tail = rd.signal[rd.read_start_rel_to_raw :]
    try:
        csig, pos0, vlen, feats, shift, scale = native.compact_read_native_arrays(
            tail, rd.starts, rd.bases, rd.lengths, rd.ab_mean, rd.ab_std,
            query_len, mad=rd.mad, out=out)
    except native.NativeError as exc:
        if exc.rc == native.CAPACITY and out is not None:
            return compact_read(rd, query_len)
        _fall_back(exc)
        return compact_read_numpy(rd, query_len)
    return CompactRead(bases=rd.bases, csig=csig, pos0=pos0, vlen=vlen,
                       feats=feats, shift=shift, scale=scale)


def compact_fast5(
    path: str,
    basecall_group: str = "Basecall_1D_000",
    basecall_subgroup: str = "BaseCalled_template",
    out: tuple | None = None,
) -> CompactRead:
    """Decode and compact one fast5 in one host-library call
    (``nr_fast5_compact``), equal to ``compact_read(get_read_data(path))``.

    ``out``: (csig, pos0, vlen, feats[, bases]) arrays to fill in place; a
    read larger than them is compacted once more into arrays of the size the
    library reports. A file the library refuses is read again by
    ``io.fast5.get_read_data``: a bad read raises its ``Fast5Error`` there,
    and a read the Python path does read is compacted by ``compact_read``
    and counted in ``native_fallbacks``."""
    try:
        try:
            return _ingest(path, basecall_group, basecall_subgroup, out)
        except native.NativeError as exc:
            if exc.rc != native.CAPACITY:
                raise
            n, m = exc.need
            return _ingest(path, basecall_group, basecall_subgroup,
                           (np.empty(m, np.int16), np.empty(n, np.int32),
                            np.empty(n, np.uint8), np.empty((n, 6), np.float16)))
    except native.NativeError as exc:
        refused = exc
    rd = get_read_data(path, basecall_group, basecall_subgroup)
    before = _native_fallbacks
    c = compact_read(rd, out=None if out is None else out[:4])
    if _native_fallbacks == before:
        _fall_back(refused)
    return c


def _ingest(path: str, group: str, subgroup: str, out) -> CompactRead:
    bases, csig, pos0, vlen, feats, shift, scale = native.fast5_compact_native(
        path, group, subgroup, QUERY_LEN, out=out)
    return CompactRead(bases=bases, csig=csig, pos0=pos0, vlen=vlen,
                       feats=feats, shift=shift, scale=scale)


# ---- the prep pool's worker entry points (infer.hostpipe) ------------------
# A worker decodes, compacts and wire-encodes a read into a /dev/shm slot;
# only the small fields travel back through the pool's result pipe.

_WORKER_SLOTS: dict = {}
_WORKER_SCRATCH: dict = {}


def _pool_init(ready) -> None:
    """Worker initializer: load the host library, then release ``ready``
    (a semaphore), so the pool can tell when its workers have started."""
    native.load()
    ready.release()


def _compact_scratch(cap_bases: int, cap_samples: int) -> tuple:
    """This process's reusable ingest outputs (csig, pos0, vlen, feats,
    bases)."""
    key = (cap_bases, cap_samples)
    s = _WORKER_SCRATCH.get(key)
    if s is None:
        s = (np.empty(cap_samples, np.int16), np.empty(cap_bases, np.int32),
             np.empty(cap_bases, np.uint8), np.empty((cap_bases, 6), np.float16),
             np.empty(cap_bases, np.uint8))
        _WORKER_SCRATCH[key] = s
    return s


def _compact_bounded(path: str, group: str, subgroup: str, cap_bases: int,
                     cap_samples: int) -> CompactRead:
    """``compact_fast5`` into this process's scratch arrays; a read beyond
    them is compacted into new arrays of its size."""
    return compact_fast5(path, group, subgroup,
                         out=_compact_scratch(cap_bases, cap_samples))


def slot_layout(cap_bases: int, cap_samples: int | None = None) -> dict:
    """Byte offsets of one prep slot holding a wire-encoded read: u8 signal
    deltas | u8 pos deltas | f16 evf[., 4] | u8 codes | the signal,
    duration, vlen and color escape arrays. ``cap_samples`` defaults to the
    largest compaction of ``cap_bases`` bases (50 samples each)."""
    if cap_samples is None:
        cap_samples = QUERY_LEN * cap_bases
    caps = {"esc_cap": cap_samples // 64,    # 1.56% of samples
            "dur_cap": cap_bases // 16, "vl_cap": 4096, "col_cap": 4096}
    off, pos = {}, 0
    for name, nbytes in (
        ("sig8", cap_samples),
        ("posd", cap_bases),
        ("evf", 2 * 4 * cap_bases),
        ("codes", cap_bases),
        ("sig_esc_idx", 4 * caps["esc_cap"]),
        ("sig_esc_delta", 4 * caps["esc_cap"]),
        ("dur_esc_idx", 4 * caps["dur_cap"]),
        ("dur_esc_f32", 4 * caps["dur_cap"]),
        ("vlen_esc_idx", 4 * caps["vl_cap"]),
        ("vlen_esc_val", 4 * caps["vl_cap"]),
        ("col_esc_idx", 4 * caps["col_cap"]),
    ):
        off[name] = pos
        pos += nbytes
    return {**off, **caps, "total": pos, "cap_samples": cap_samples}


def _worker_slot(slot_path: str) -> np.memmap:
    m = _WORKER_SLOTS.get(slot_path)
    if m is None:
        m = np.memmap(slot_path, dtype=np.uint8, mode="r+")
        _WORKER_SLOTS[slot_path] = m
    return m


def _slot_views(buf, layout: dict, n_bases: int, m_samples: int,
                counts=None) -> dict:
    """Numpy views of one slot's wire arrays. ``counts``: (ne, nd, nv, nc)
    escape-entry counts (the full capacities when None, for the writer)."""
    ne, nd, nv, nc = counts or (
        layout["esc_cap"], layout["dur_cap"], layout["vl_cap"], layout["col_cap"])

    def view(name, dtype, count):
        return np.frombuffer(buf, dtype, count, layout[name])

    return {
        "sig8": view("sig8", np.uint8, m_samples),
        "posd": view("posd", np.uint8, n_bases),
        "evf": view("evf", np.float16, n_bases * 4).reshape(n_bases, 4),
        "codes": view("codes", np.uint8, n_bases),
        "sig_esc_idx": view("sig_esc_idx", np.int32, ne),
        "sig_esc_delta": view("sig_esc_delta", np.int32, ne),
        "dur_esc_idx": view("dur_esc_idx", np.int32, nd),
        "dur_esc_f32": view("dur_esc_f32", np.float32, nd),
        "vlen_esc_idx": view("vlen_esc_idx", np.int32, nv),
        "vlen_esc_val": view("vlen_esc_val", np.int32, nv),
        "col_esc_idx": view("col_esc_idx", np.int32, nc),
    }


def _pool_prep_one(path: str, buf, group: str, subgroup: str, cap_bases: int,
                   cap_samples: int):
    """Decode (basecall ``group``/``subgroup``), compact and wire-encode one
    fast5 into ``buf`` (a slot's bytes, or None). Returns (payload, error,
    native_fallbacks):

    * payload (n, m, shift, scale, bases, first_val, last_val, pos0_first,
      pos0_last, ne, nd, nv, nc) when the read is in ``buf``;
    * payload a ``WireRead`` of its own arrays when there is no ``buf`` or
      the read exceeds a slot capacity (it travels pickled);
    * payload None and the error text when the read failed.

    native_fallbacks counts the read's reruns on the numpy path."""
    from ..infer.wire import encode_read, validate_chain_bounds

    before = _native_fallbacks
    try:
        c = _compact_bounded(path, group, subgroup, cap_bases, cap_samples)
        n, m = c.n_bases, c.n_samples
        if buf is None or n > cap_bases or m > cap_samples:
            return encode_read(c), None, _native_fallbacks - before
        # the library leaves the chain bounds to its caller
        validate_chain_bounds(int(c.pos0[0]), int(c.pos0[n - 1]), m)
        layout = slot_layout(cap_bases, cap_samples)
        v = _slot_views(buf, layout, n, m)
        try:
            ne, nd, nv, nc = native.encode_wire_native(c, v)
        except native.NativeError as exc:
            if exc.rc == native.CAPACITY:   # escapes beyond the slot's lists
                return encode_read(c), None, _native_fallbacks - before
            _fall_back(exc)
            w = encode_read(c, out=(v["sig8"], v["posd"], v["evf"], v["codes"]))
            ne, nd = len(w.sig_esc_idx), len(w.dur_esc_idx)
            nv, nc = len(w.vlen_esc_idx), len(w.col_esc_idx)
            if (ne > layout["esc_cap"] or nd > layout["dur_cap"]
                    or nv > layout["vl_cap"] or nc > layout["col_cap"]):
                return w, None, _native_fallbacks - before
            for k in ("sig_esc_idx", "sig_esc_delta", "dur_esc_idx",
                      "dur_esc_f32", "vlen_esc_idx", "vlen_esc_val",
                      "col_esc_idx"):
                v[k][: len(getattr(w, k))] = getattr(w, k)
        return ((n, m, c.shift, c.scale, c.bases, int(c.csig[0]),
                 int(c.csig[m - 1]), int(c.pos0[0]), int(c.pos0[n - 1]),
                 ne, nd, nv, nc), None, _native_fallbacks - before)
    except Exception as exc:  # noqa: BLE001 — a bad read fails alone
        return None, str(exc), _native_fallbacks - before


def _pool_chunk(job, paths: list, slot_paths: list, *spec) -> tuple[list, float]:
    """A chunk of reads per task: one round trip through the pool's pipes
    for several reads. ``job(path, buf, *spec)`` is ``_pool_prep_one`` or
    ``_pool_signal_one``, ``buf`` the /dev/shm slot at each slot path
    (None: no slot was free, the read travels pickled). Returns their
    results and this worker's ``perf_counter`` seconds over them (decode,
    compact or read, encode, slot write)."""
    t = time.perf_counter()
    out = [job(p, _worker_slot(s) if s is not None else None, *spec)
           for p, s in zip(paths, slot_paths)]
    return out, time.perf_counter() - t


# ---- the basecaller's signal job (infer.basecall): a read's whole raw
# signal, as int16 in a slot, with the normalisers of Bonito's med/MAD

MAD_FACTOR = 1.4826


@dataclass
class SignalRead:
    """A read's whole raw signal; the basecaller reads ``(signal - shift) /
    scale``."""

    signal: np.ndarray     # [S] int16, the whole raw signal
    shift: float           # median
    scale: float           # MAD x 1.4826 (1.0 where that is 0)

    @property
    def n_samples(self) -> int:
        return len(self.signal)


def read_raw_signal(path: str) -> np.ndarray:
    """The int16 ``Signal`` of a single-read fast5's first read under
    ``/Raw/Reads``."""
    try:
        with hdf5.File(path, "r") as f:
            reads = f["/Raw/Reads/"]
            sig = reads[reads.keys()[0] + "/Signal"][()]
    except Exception as exc:  # noqa: BLE001
        raise Fast5Error(f"no raw signal in the file ({exc})") from exc
    sig = np.asarray(sig)
    if sig.dtype != np.int16 or sig.ndim != 1 or len(sig) == 0:
        raise Fast5Error(f"raw signal is not a non-empty int16 vector "
                         f"({sig.dtype}, shape {sig.shape})")
    return sig


def signal_normalizers(sig: np.ndarray) -> tuple[float, float]:
    """(median, MAD x 1.4826) of the whole read, exact (``segmentation.
    mad_normalizers_int16``); a MAD of 0 scales by 1."""
    shift, mad = mad_normalizers_int16(sig)
    scale = mad * MAD_FACTOR
    return shift, (scale if scale > 0 else 1.0)


def _pool_signal_one(path: str, buf):
    """One fast5's raw signal into ``buf`` (a slot's bytes, or None).
    Returns (payload, error, 0): payload (n, shift, scale) when the signal
    is in ``buf``, a ``SignalRead`` of its own array when there is no
    ``buf`` or it is too small, None with the error text when the read
    failed."""
    try:
        sig = read_raw_signal(path)
        shift, scale = signal_normalizers(sig)
        n = len(sig)
        if buf is None or 2 * n > len(buf):
            return SignalRead(sig, shift, scale), None, 0
        buf[: 2 * n].view(np.int16)[:] = sig
        return (n, shift, scale), None, 0
    except Exception as exc:  # noqa: BLE001 — a bad read fails alone
        return None, str(exc), 0
