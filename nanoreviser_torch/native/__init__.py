"""ctypes bindings of the host library (``src/nanorev.cpp``).

Counterpart of ``nanoreviser_tpu/native/__init__.py:60-385``, for the
entries the serving path calls and the training labeller's aligner:

* ``fast5_compact_native``       - the fast5 ingest: decode and compaction
                                   of one file in one call
                                   (``compact_read(get_read_data(path))``);
* ``prep_read_native_arrays``    - windowed prep (``prep_read_numpy``);
* ``compact_read_native_arrays`` - compaction (``compact_read_numpy``);
* ``encode_wire_native``         - wire encode (``infer.wire.encode_read``);
* ``banded_sw_native``           - the banded aligner
                                   (``align.sw.banded_sw_torch``);
* ``write_files_native``         - a burst of output files in one call
                                   (``io.writers.FileWriter``'s thread).

Each is exact with its twin (``tests/test_torch_fast5_native.py``,
``tests/test_torch_native.py``, ``tests/test_torch_align.py``,
``tests/test_torch_writer.py``) and runs
with the GIL released. The library is built by g++ and loaded at the first
call, never at import (``native.build``); a build that fails raises.
A call the library refuses raises :class:`NativeError` with its return
code; ``CAPACITY`` (-2) means a caller's output buffer was too small.

The ingest reads the HDF5 subset that ``io.hdf5`` reads (superblocks 0-3,
object headers v1/v2, symbol-table and compact-link groups, compact,
contiguous and v1-B-tree chunked layouts with the deflate and shuffle
filters, attributes v1-3) with its own C++ reader; the JAX package's
counterpart loads h5py's libhdf5, which the card's host does not have.
Deflate goes through zlib, which the library loads with ``dlopen`` at first
use, so the library builds without zlib's header and runs, compressed files
aside, without zlib (``zlib_available``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

CAPACITY = -2
# nr_fast5_compact's other codes: INVALID (-1, the decoded arrays are
# refused by the compaction), -3 open or malformed file, -4 events too short,
# -5 signal shorter than the events, and
SUBSET = -6         # outside the HDF5 subset the library reads
NO_ZLIB = -7        # a compressed dataset and no libz

_lib = None
_lock = threading.Lock()

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_DBL_P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "nr_fast5_compact": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,  # path, group, subgroup
        ctypes.c_int,             # qlen
        _P, _I64,                 # bases, capacity (rows of pos0/vlen/feats too)
        _DBL_P, _DBL_P,           # shift, scale (out)
        _P, _I64,                 # csig, capacity
        _P, _P, _P,               # pos0, vlen, feats
        _P,                       # counts out [2]: bases, samples
    ]),
    "nr_zlib_loaded": (ctypes.c_int, []),
    "nr_prep_read": (ctypes.c_int, [
        _P, _I64,                 # tail, n_samples
        _P, _I64,                 # starts, n_bases
        _P, _P,                   # bases (ascii), durations f32
        _P, _P,                   # ab_mean, ab_std f32
        ctypes.c_int,             # qlen
        _DBL_P, _DBL_P,           # shift, scale (in/out)
        _P, _P, _P,               # win, vlen, feats
    ]),
    "nr_compact_read": (ctypes.c_int64, [
        _P, _I64, _P, _I64, _P, _P, _P, _P, ctypes.c_int, _DBL_P, _DBL_P,
        _P, _I64,                 # csig, capacity
        _P, _P, _P,               # pos0, vlen, feats
    ]),
    "nr_banded_sw": (ctypes.c_int, [
        _P, _I64,                 # q, m
        _P, _I64,                 # t, n
        ctypes.c_int, _I64, _I64,  # band, t_lead, t_tail
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _P, _I64,                 # ops_out, capacity
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
    ]),
    "nr_encode_wire": (ctypes.c_int64, [
        _P, _I64,                 # csig, m
        _P, _P, _P, _P,           # pos0, vlen, feats, bases
        _I64,                     # n
        _P, _P, _P, _I64,         # sig8, sig escapes (idx, delta), capacity
        _P, _P, _P,               # posd, evf, codes
        _P, _P, _I64,             # duration escapes, capacity
        _P, _P, _I64,             # vlen escapes, capacity
        _P, _I64,                 # color escapes, capacity
        _P,                       # counts out [4]
    ]),
    "nr_write_files": (ctypes.c_int64, [
        _I64, ctypes.c_char_p,    # n, NUL-separated paths
        ctypes.c_char_p, _P,      # data, ends i64 [n]
        _P,                       # errs i32 [n] out
    ]),
}


class NativeError(RuntimeError):
    """The library refused a call; ``rc`` is its return code. ``need``:
    the (bases, samples) a ``CAPACITY`` refusal of the ingest asks for."""

    def __init__(self, entry: str, rc: int, need: tuple | None = None):
        super().__init__(f"{entry} failed (rc={rc})")
        self.rc = rc
        self.need = need


def load() -> ctypes.CDLL:
    """The library, built on first use (its file name holds a hash of the
    source, so a stale build is never loaded)."""
    global _lib
    with _lock:
        if _lib is None:
            from .build import build

            lib = ctypes.CDLL(str(build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def _read_inputs(tail, starts, bases: str, durations, ab_mean, ab_std):
    tail = np.ascontiguousarray(tail, np.int16)
    starts = np.ascontiguousarray(starts, np.int32)
    base_bytes = bases.encode("ascii")
    dur = np.ascontiguousarray(durations, np.float32)
    abm = np.ascontiguousarray(ab_mean, np.float32)
    abs_ = np.ascontiguousarray(ab_std, np.float32)
    n = len(starts)
    if not (len(base_bytes) == len(dur) == len(abm) == len(abs_) == n):
        raise ValueError("per-base arrays differ in length")
    return tail, starts, base_bytes, dur, abm, abs_


def _starts_in_range(starts: np.ndarray, n_samples: int) -> bool:
    """The library copies [st - 25, st + 25) clamped to the signal: every
    start must lie inside it, in order (compared, not subtracted: an int32
    difference could wrap)."""
    return (len(starts) > 0 and n_samples > 0 and int(starts[0]) >= 0
            and int(starts[-1]) < n_samples
            and bool((starts[1:] >= starts[:-1]).all()))


def _check_out(arr, dtype, min_len: int, name: str, width: int | None = None):
    if arr.dtype != dtype or not arr.flags.c_contiguous or not arr.flags.writeable:
        raise ValueError(f"out array {name} must be writable, C-contiguous {dtype}")
    if width is not None and (arr.ndim != 2 or arr.shape[1] != width):
        raise ValueError(f"out array {name} must have {width} columns")
    return len(arr) >= min_len


def prep_read_native_arrays(tail, starts, bases: str, durations, ab_mean,
                            ab_std, query_len: int, mad: tuple | None = None,
                            out: tuple | None = None):
    """(win i16 [N, Q], vlen u8 [N], feats f16 [N, 6], shift, scale) by
    ``nr_prep_read``. ``out``: (win, vlen, feats) arrays of at least N rows
    to fill in place; the returned arrays are their first N rows."""
    lib = load()
    tail, starts, base_bytes, dur, abm, abs_ = _read_inputs(
        tail, starts, bases, durations, ab_mean, ab_std)
    n = len(starts)
    if out is None:
        out = (np.empty((n, query_len), np.int16), np.empty(n, np.uint8),
               np.empty((n, 6), np.float16))
    win, vlen, feats = out
    fits = (_check_out(win, np.int16, n, "win", query_len)
            & _check_out(vlen, np.uint8, n, "vlen")
            & _check_out(feats, np.float16, n, "feats", 6))
    if not fits:
        raise NativeError("nr_prep_read", CAPACITY)
    if not _starts_in_range(starts, len(tail)):
        raise NativeError("nr_prep_read", -1)
    shift = ctypes.c_double(mad[0] if mad else -1e31)
    scale = ctypes.c_double(mad[1] if mad else -1e31)
    rc = lib.nr_prep_read(
        tail.ctypes.data, len(tail), starts.ctypes.data, n, base_bytes,
        dur.ctypes.data, abm.ctypes.data, abs_.ctypes.data, query_len,
        ctypes.byref(shift), ctypes.byref(scale),
        win.ctypes.data, vlen.ctypes.data, feats.ctypes.data)
    if rc != 0:
        raise NativeError("nr_prep_read", rc)
    return win[:n], vlen[:n], feats[:n], float(shift.value), float(scale.value)


def compact_read_native_arrays(tail, starts, bases: str, durations, ab_mean,
                               ab_std, query_len: int, mad: tuple | None = None,
                               out: tuple | None = None):
    """(csig i16 [M], pos0 i32 [N], vlen u8 [N], feats f16 [N, 6], shift,
    scale) by ``nr_compact_read``. ``out``: (csig, pos0, vlen, feats) arrays
    to fill in place (csig's length is the sample capacity); the returned
    arrays are their filled prefixes. Raises ``NativeError`` with rc
    ``CAPACITY`` when they are too small."""
    lib = load()
    tail, starts, base_bytes, dur, abm, abs_ = _read_inputs(
        tail, starts, bases, durations, ab_mean, ab_std)
    n = len(starts)
    if out is None:
        # the compacted signal is at most one window per base and at most
        # the whole tail
        out = (np.empty(min(n * query_len, len(tail)) + query_len, np.int16),
               np.empty(n, np.int32), np.empty(n, np.uint8),
               np.empty((n, 6), np.float16))
    csig, pos0, vlen, feats = out
    fits = (_check_out(csig, np.int16, 0, "csig")
            & _check_out(pos0, np.int32, n, "pos0")
            & _check_out(vlen, np.uint8, n, "vlen")
            & _check_out(feats, np.float16, n, "feats", 6))
    if not fits:
        raise NativeError("nr_compact_read", CAPACITY)
    if not _starts_in_range(starts, len(tail)):
        raise NativeError("nr_compact_read", -1)
    shift = ctypes.c_double(mad[0] if mad else -1e31)
    scale = ctypes.c_double(mad[1] if mad else -1e31)
    m = lib.nr_compact_read(
        tail.ctypes.data, len(tail), starts.ctypes.data, n, base_bytes,
        dur.ctypes.data, abm.ctypes.data, abs_.ctypes.data, query_len,
        ctypes.byref(shift), ctypes.byref(scale),
        csig.ctypes.data, len(csig),
        pos0.ctypes.data, vlen.ctypes.data, feats.ctypes.data)
    if m < 0:
        raise NativeError("nr_compact_read", m)
    return (csig[:m], pos0[:n], vlen[:n], feats[:n],
            float(shift.value), float(scale.value))


# the ingest's output rows and samples when its caller gives no arrays (a
# 10k-base read needs ~1e4 and ~1e5); a larger read is refused with its
# sizes (``CAPACITY``)
INGEST_BASES, INGEST_SAMPLES = 1 << 16, 1 << 20


def zlib_available() -> bool:
    """Whether the library loaded libz (compressed fast5 files need it)."""
    return bool(load().nr_zlib_loaded())


def fast5_compact_native(path, basecall_group: str, basecall_subgroup: str,
                         query_len: int = 50, out: tuple | None = None):
    """(bases str, csig i16 [M], pos0 i32 [N], vlen u8 [N], feats f16 [N, 6],
    shift, scale) of one fast5 by ``nr_fast5_compact``: the decode of
    ``io.fast5.get_read_data`` and the compaction of ``compact_read`` in one
    call. ``out``: (csig, pos0, vlen, feats[, bases u8]) arrays to fill in
    place (csig's length is the sample capacity, the shortest of the others
    the base capacity); the returned arrays are their filled prefixes.
    Raises ``NativeError``: rc ``CAPACITY`` with ``need`` = (bases, samples)
    when the arrays are too small, any other code when the library refuses
    the file (a read the Python path may still read, or fail)."""
    lib = load()
    if out is None:
        out = (np.empty(INGEST_SAMPLES, np.int16), np.empty(INGEST_BASES, np.int32),
               np.empty(INGEST_BASES, np.uint8), np.empty((INGEST_BASES, 6), np.float16))
    csig, pos0, vlen, feats = out[:4]
    bases = out[4] if len(out) > 4 else np.empty(len(pos0), np.uint8)
    for arr, dt, name, w in ((csig, np.int16, "csig", None), (pos0, np.int32, "pos0", None),
                             (vlen, np.uint8, "vlen", None), (feats, np.float16, "feats", 6),
                             (bases, np.uint8, "bases", None)):
        _check_out(arr, dt, 0, name, w)
    cap = min(len(pos0), len(vlen), len(feats), len(bases))
    shift, scale = ctypes.c_double(), ctypes.c_double()
    counts = np.zeros(2, np.int64)
    n = lib.nr_fast5_compact(
        os.fsencode(path), basecall_group.encode(), basecall_subgroup.encode(),
        query_len, bases.ctypes.data, cap, ctypes.byref(shift), ctypes.byref(scale),
        csig.ctypes.data, len(csig), pos0.ctypes.data, vlen.ctypes.data,
        feats.ctypes.data, counts.ctypes.data)
    if n < 0:
        need = (int(counts[0]), int(counts[1])) if n == CAPACITY else None
        raise NativeError("nr_fast5_compact", n, need)
    m = int(counts[1])
    return (bases[:n].tobytes().decode("ascii"), csig[:m], pos0[:n], vlen[:n],
            feats[:n], float(shift.value), float(scale.value))


ENCODE_OUT = {  # name: (dtype, columns)
    "sig8": (np.uint8, None), "posd": (np.uint8, None),
    "evf": (np.float16, 4), "codes": (np.uint8, None),
    "sig_esc_idx": (np.int32, None), "sig_esc_delta": (np.int32, None),
    "dur_esc_idx": (np.int32, None), "dur_esc_f32": (np.float32, None),
    "vlen_esc_idx": (np.int32, None), "vlen_esc_val": (np.int32, None),
    "col_esc_idx": (np.int32, None),
}


def encode_wire_native(c, out: dict) -> tuple[int, int, int, int]:
    """Wire-encode a ``CompactRead`` into the caller's arrays by
    ``nr_encode_wire``; returns the escape counts (ne, nd, nv, nc).

    ``out`` holds the arrays of ``ENCODE_OUT``: sig8 of at least M entries,
    posd/evf/codes of at least N rows, and escape arrays whose lengths are
    the capacities (each pair of one length). Raises ``NativeError``: rc
    ``CAPACITY`` when an array is too small, -6 when a pos0 row delta is
    outside [0, 50]. The chain bounds (``validate_chain_bounds``) are the
    caller's to check."""
    lib = load()
    n, m = c.n_bases, c.n_samples
    csig = c.csig
    ins = ((csig, np.int16), (c.pos0, np.int32), (c.vlen, np.uint8),
           (c.feats, np.float16))
    if any(a.dtype != dt or not a.flags.c_contiguous for a, dt in ins):
        raise ValueError("CompactRead arrays must be C-contiguous i16/i32/u8/f16")
    if c.pos0.shape != (n,) or c.feats.shape != (n, 6):
        raise ValueError("CompactRead arrays differ in length")
    bases = np.frombuffer(c.bases.encode("ascii"), np.uint8)
    if len(bases) != n:
        raise ValueError("CompactRead bases differ in length")
    need = {"sig8": m, "posd": n, "evf": n, "codes": n}
    fits = all([_check_out(out[k], dt, need.get(k, 0), k, w)
                for k, (dt, w) in ENCODE_OUT.items()])
    if not fits:
        raise NativeError("nr_encode_wire", CAPACITY)
    for a, b in (("sig_esc_idx", "sig_esc_delta"), ("dur_esc_idx", "dur_esc_f32"),
                 ("vlen_esc_idx", "vlen_esc_val")):
        if len(out[a]) != len(out[b]):
            raise ValueError(f"out arrays {a} and {b} differ in length")
    counts = np.zeros(4, np.int64)
    rc = lib.nr_encode_wire(
        csig.ctypes.data, m, c.pos0.ctypes.data, c.vlen.ctypes.data,
        c.feats.ctypes.data, bases.ctypes.data, n,
        out["sig8"].ctypes.data, out["sig_esc_idx"].ctypes.data,
        out["sig_esc_delta"].ctypes.data, len(out["sig_esc_idx"]),
        out["posd"].ctypes.data, out["evf"].ctypes.data, out["codes"].ctypes.data,
        out["dur_esc_idx"].ctypes.data, out["dur_esc_f32"].ctypes.data,
        len(out["dur_esc_idx"]),
        out["vlen_esc_idx"].ctypes.data, out["vlen_esc_val"].ctypes.data,
        len(out["vlen_esc_idx"]),
        out["col_esc_idx"].ctypes.data, len(out["col_esc_idx"]),
        counts.ctypes.data)
    if rc != 0:
        raise NativeError("nr_encode_wire", rc)
    return int(counts[0]), int(counts[1]), int(counts[2]), int(counts[3])


def banded_sw_native(q_codes, t_codes, band: int = 512, t_lead: int = 0,
                     t_tail: int = 0, match: float = 2.0, mismatch: float = -3.0,
                     gap_open: float = -5.0, gap_extend: float = -2.0):
    """(ops int8 [K], j_start, score) of the banded glocal alignment of base
    codes ``q_codes`` against ``t_codes`` by ``nr_banded_sw``."""
    lib = load()
    q = np.ascontiguousarray(q_codes, np.int8)
    t = np.ascontiguousarray(t_codes, np.int8)
    if len(q) < 1 or len(t) < 1 or band < 4:
        raise ValueError(f"banded_sw_native: m={len(q)}, n={len(t)}, band={band}")
    ops = np.empty(len(q) + len(t) + 4, np.int8)
    j_start = ctypes.c_int64()
    score = ctypes.c_float()
    n_ops = lib.nr_banded_sw(
        q.ctypes.data, len(q), t.ctypes.data, len(t), band, t_lead, t_tail,
        match, mismatch, gap_open, gap_extend, ops.ctypes.data, len(ops),
        ctypes.byref(j_start), ctypes.byref(score))
    if n_ops < 0:
        raise NativeError("nr_banded_sw", n_ops)
    return ops[:n_ops].copy(), int(j_start.value), float(score.value)


def write_files_native(paths: list, datas: list) -> list[int]:
    """Write ``datas[k]`` (bytes) to ``paths[k]`` for every k by one call of
    ``nr_write_files``, each file as ``open(path, "w")`` writes its text;
    returns each file's errno (0 where it was written)."""
    lib = load()
    names = [os.fsencode(p) for p in paths]
    if len(names) != len(datas) or any(b"\0" in p for p in names):
        raise ValueError("paths and datas differ in length, or a path holds a NUL byte")
    ends = np.cumsum([len(d) for d in datas], dtype=np.int64)
    errs = np.zeros(len(names), np.int32)
    lib.nr_write_files(len(names), b"".join(p + b"\0" for p in names),
                       b"".join(datas), ends.ctypes.data, errs.ctypes.data)
    return errs.tolist()
