"""The port's host library (``nanoreviser_torch.native``) vs the JAX
package's numpy functions and the port's own (CPU; g++ builds it).

* ``compact_read`` (``nr_compact_read``) is bit-exact with
  ``compact_read_numpy`` of both packages: csig, pos0, vlen, feats, shift
  and scale, byte for byte.
* ``prep_read`` (``nr_prep_read``) is bit-exact with ``prep_read_numpy``
  inside each row's valid window span [left, left + vlen); the library
  zeroes the pad columns, numpy fills them with neighbouring samples (both
  are masked after normalization).
* ``encode_wire_native`` (``nr_encode_wire``) is bit-exact with
  ``encode_read``: every wire array and every escape list.
* Inputs: synthetic reads from several seeds (stalls, spikes, ``N``
  calls) and a read whose signal ends inside its last event.
* The ``out=`` paths fill the caller's arrays; a read larger than them is
  retried with new arrays (rc -2) and not counted as a fallback; a read the
  library refuses otherwise runs on the numpy path, which raises the JAX
  package's error text, and is counted.
"""

import dataclasses
import os

import numpy as np
import pytest

import nanoreviser_tpu.infer.wire as jwire
import nanoreviser_tpu.io as jio
import nanoreviser_tpu.signal.host_prep as jprep
from nanoreviser_torch import native
from nanoreviser_torch.infer import wire
from nanoreviser_torch.io import get_read_data
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.signal import host_prep
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """[(port ReadData, JAX ReadData)]: two reads per seed, then one cut
    inside its last event."""
    out = []
    for seed in (11, 12, 13):
        d = tmp_path_factory.mktemp(f"native{seed}")
        for n in write_synthetic_dir(d, 2, (300, 2500), seed=seed):
            p = os.path.join(d, n)
            out.append((get_read_data(p), jio.get_read_data(p)))
    rt, rj = out[0]
    cut = rt.read_start_rel_to_raw + int(rt.starts[-1]) + 1
    out.append((dataclasses.replace(rt, signal=rt.signal[:cut]),
                dataclasses.replace(rj, signal=rj.signal[:cut])))
    return out


def _assert_same(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


def _encode_out(n: int, m: int, cap: int | None = None) -> dict:
    rows = {"sig8": m, "posd": n, "evf": n, "codes": n}
    return {k: np.full((rows.get(k, cap or n), 4) if w else rows.get(k, cap or n),
                       0x55, dt)
            for k, (dt, w) in native.ENCODE_OUT.items()}


def test_compact_bit_exact_with_numpy(reads):
    n_stalls = 0
    fb = host_prep.native_fallbacks()
    for rt, rj in reads:
        c = host_prep.compact_read(rt)
        _assert_same(c, jprep.compact_read_numpy(rj))
        _assert_same(c, host_prep.compact_read_numpy(rt))
        n_stalls += int((np.diff(c.pos0) > 25).sum())
    assert host_prep.native_fallbacks() == fb
    assert n_stalls > 0                  # compaction dropped stall signal


def test_prep_bit_exact_inside_valid_span(reads):
    n_pad_diff = 0
    for rt, rj in reads:
        p = host_prep.prep_read(rt)
        ref = jprep.prep_read_numpy(rj)
        _assert_same(p, ref, skip=("win",))
        _assert_same(host_prep.prep_read_numpy(rt), ref)
        left = (50 - ref.vlen.astype(np.int32) + 1) // 2
        cols = np.arange(50)[None, :]
        span = (cols >= left[:, None]) & (cols < (left + ref.vlen)[:, None])
        assert p.win.tobytes() != b"" and (p.win[span] == ref.win[span]).all()
        assert not p.win[~span].any()
        n_pad_diff += int((p.win[~span] != ref.win[~span]).sum())
    assert n_pad_diff > 0                # the pad columns really differ


def test_encode_bit_exact_with_encode_read(reads):
    n_esc = np.zeros(4, int)
    for rt, rj in reads:
        c = host_prep.compact_read(rt)
        n, m = c.n_bases, c.n_samples
        out = _encode_out(n, m)
        counts = native.encode_wire_native(c, out)
        want = jwire.encode_read(jprep.compact_read_numpy(rj))
        _assert_same(wire.encode_read(c), want)
        got = {k: v[: counts[i]] for i, ks in enumerate(
            (("sig_esc_idx", "sig_esc_delta"), ("dur_esc_idx", "dur_esc_f32"),
             ("vlen_esc_idx", "vlen_esc_val"), ("col_esc_idx",)))
            for k, v in out.items() if k in ks}
        for k in ("sig8", "posd", "evf", "codes"):
            got[k] = out[k]
        for k, v in got.items():
            w = getattr(want, k)
            assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), k
        n_esc += counts
    assert (n_esc > 0).all()             # every escape list is exercised


def test_out_paths_fill_the_callers_arrays(reads):
    rt, rj = reads[2]
    n = rt.n_bases
    scratch = (np.empty(60 * n, np.int16), np.empty(n + 7, np.int32),
               np.empty(n + 7, np.uint8), np.empty((n + 7, 6), np.float16))
    c = host_prep.compact_read(rt, out=scratch)
    for got, buf in zip((c.csig, c.pos0, c.vlen, c.feats), scratch):
        assert np.shares_memory(got, buf)
    _assert_same(c, jprep.compact_read_numpy(rj))

    wins = (np.empty((n, 50), np.int16), np.empty(n, np.uint8),
            np.empty((n, 6), np.float16))
    p = host_prep.prep_read(rt, out=wins)
    assert np.shares_memory(p.win, wins[0])
    _assert_same(p, host_prep.prep_read(rt))

    m = c.n_samples
    bufs = (np.empty(m + 9, np.uint8), np.empty(n + 9, np.uint8),
            np.empty((n + 9, 4), np.float16), np.empty(n + 9, np.uint8))
    w = wire.encode_read(c, out=bufs)
    assert all(np.shares_memory(a, b) for a, b in
               zip((w.sig8, w.posd, w.evf, w.codes), bufs))
    cj = jprep.compact_read_numpy(rj)
    jbufs = tuple(np.empty_like(b) for b in bufs)
    _assert_same(w, jwire.encode_read(cj, out=jbufs))
    _assert_same(w, jwire.encode_read(cj))


def test_capacity_retry_and_numpy_fallback(reads):
    rt, rj = reads[0]
    n = rt.n_bases
    fb = host_prep.native_fallbacks()
    small = (np.empty(100, np.int16), np.empty(n, np.int32),
             np.empty(n, np.uint8), np.empty((n, 6), np.float16))
    tail = rt.signal[rt.read_start_rel_to_raw :]
    with pytest.raises(native.NativeError) as exc:
        native.compact_read_native_arrays(tail, rt.starts, rt.bases, rt.lengths,
                                          rt.ab_mean, rt.ab_std, 50, out=small)
    assert exc.value.rc == native.CAPACITY
    c = host_prep.compact_read(rt, out=small)       # retried with new arrays
    assert not np.shares_memory(c.csig, small[0])
    _assert_same(c, jprep.compact_read_numpy(rj))
    short = (np.empty((n - 1, 50), np.int16), np.empty(n - 1, np.uint8),
             np.empty((n - 1, 6), np.float16))
    _assert_same(host_prep.prep_read(rt, out=short), host_prep.prep_read(rt))
    with pytest.raises(native.NativeError) as exc:
        native.encode_wire_native(c, _encode_out(n, c.n_samples, cap=1))
    assert exc.value.rc == native.CAPACITY
    assert host_prep.native_fallbacks() == fb

    # no signal after the read start: the library refuses the read, the
    # numpy path runs it and raises as the JAX package's numpy path does
    empty_t = dataclasses.replace(rt, read_start_rel_to_raw=len(rt.signal))
    empty_j = dataclasses.replace(rj, read_start_rel_to_raw=len(rj.signal))
    with pytest.raises(Exception) as want:
        jprep.compact_read_numpy(empty_j)
    with pytest.raises(type(want.value)) as got:
        host_prep.compact_read(empty_t)
    assert str(got.value) == str(want.value)
    assert host_prep.native_fallbacks() == fb + 1


def test_refused_encode_reruns_numpy_in_the_worker_path(reads, monkeypatch):
    """A pos0 row delta over 50: nr_encode_wire refuses it (rc -6), the
    numpy encoder raises the JAX package's WireEncodeError text, and the
    read fails alone, counted as one fallback."""
    rt, rj = reads[1]
    c = host_prep.compact_read(rt)
    k = int(np.argmax(np.diff(c.pos0) > 0)) + 1
    pos0 = c.pos0.copy()
    pos0[k:] += 60
    bad = dataclasses.replace(c, pos0=pos0, csig=np.concatenate(
        [c.csig, np.zeros(60, np.int16)]))
    with pytest.raises(native.NativeError) as exc:
        native.encode_wire_native(bad, _encode_out(c.n_bases, bad.n_samples))
    assert exc.value.rc == -6
    cj = jprep.compact_read_numpy(rj)
    with pytest.raises(jwire.WireEncodeError) as want:
        jwire.encode_read(dataclasses.replace(cj, pos0=pos0, csig=bad.csig))
    monkeypatch.setattr(host_prep, "_compact_bounded", lambda *a: bad)
    layout = host_prep.slot_layout(4096, 65536)
    payload, err, fb = host_prep._pool_prep_one(
        "unused", np.zeros(layout["total"], np.uint8), "g", "s", 4096, 65536)
    assert payload is None and err == str(want.value) and fb == 1
