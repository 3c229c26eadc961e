"""The port's prep pool (``infer.hostpipe.PrepPool``) and the CLI's
failed-read contract (CPU).

* ``PrepPool(0)`` and ``PrepPool(2)`` over synthetic reads plus one file
  that is not HDF5 yield the same names in the same order, and the same
  failures, as the JAX package's ``PrepPool(2)``; their ``WireRead``s are
  byte-identical to it and to ``encode_read(compact_read_numpy(...))``.
* A stream longer than the ring of slots revises (``emit="labels"``,
  ``device="cpu"``) exactly as the reads themselves do.
* A read beyond the slot caps travels pickled; the ``/dev/shm`` space
  check raises before any slot exists; the stale-slot collector removes a
  dead process's slot under the port's prefix and nothing else.
* Workers import neither torch, nor jax, nor ``nanoreviser_tpu``.
* The CLI in model mode (``--device cpu --thread 2``) exits 1, lists the
  non-HDF5 file in the ``-e`` file and writes one output per good read.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nanoreviser_tpu.infer.hostpipe as jhostpipe
from nanoreviser_torch.infer import StreamingReviser, hostpipe
from nanoreviser_torch.infer.hostpipe import PrepPool
from nanoreviser_torch.infer.wire import encode_read
from nanoreviser_torch.io import get_read_data, list_fast5_files
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.models import ReviserConfig, init_reviser_params, save_keras_weights
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.signal.host_prep import compact_read_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

BAD = "read_0002_not_hdf5.fast5"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("hostpipe")
    fast5 = str(d / "fast5")
    names = write_synthetic_dir(fast5, 5, (150, 600), seed=41)
    with open(os.path.join(fast5, BAD), "wb") as fp:
        fp.write(b"this is not an HDF5 file\n" * 8)
    paths = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(400 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=11, n_classes=nc)), gen)
        paths.append(str(d / f"m{k + 1}.h5"))
        save_keras_weights(p, paths[-1], 11, nc)
    return d, fast5, names, paths


def _snapshot(stream) -> list:
    """(name, field dict or None, failed) per item, copied before advancing
    (a slot is recycled when the next item is asked for)."""
    out = []
    for fn, w, err in stream:
        fields = None if w is None else {
            f.name: (getattr(w, f.name).copy() if isinstance(
                getattr(w, f.name), np.ndarray) else getattr(w, f.name))
            for f in dataclasses.fields(w)}
        out.append((fn, fields, err is not None))
    return out


def _same(a: dict, b: dict) -> bool:
    for k, x in a.items():
        y = b[k]
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                return False
        elif x != y:
            return False
    return True


def test_pool_matches_inline_and_jax_pool(setup):
    _, fast5, names, _ = setup
    fns = list_fast5_files(fast5)
    assert BAD in fns
    with jhostpipe.PrepPool(2) as jp:
        want = _snapshot(jp.stream(fast5, fns))
    for n_workers in (0, 2):
        with PrepPool(n_workers) as pool:
            got = _snapshot(pool.stream(fast5, fns))
            assert pool.native_fallbacks == 0
        assert [(fn, bad) for fn, _, bad in got] == [(fn, bad) for fn, _, bad in want]
        assert [fn for fn, _, bad in got if bad] == [BAD]
        with PrepPool(n_workers, basecall_group="Basecall_1D_001") as pool:
            assert all(err for _, _, err in pool.stream(fast5, names))
        for (fn, g, _), (_, w, _) in zip(got, want):
            if g is not None:
                assert _same(g, w), fn
                ref = encode_read(compact_read_numpy(
                    get_read_data(os.path.join(fast5, fn))))
                assert _same(g, {f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)}), fn


def test_stream_longer_than_the_slots_revises_as_inline(setup):
    _, fast5, names, paths = setup
    fns = names[:4] * 3
    eng = StreamingReviser(*paths, batch_windows=8192, device="cpu")
    want = [(n, y1, y2) for n, _, y1, y2 in eng.revise_stream(
        [(n, get_read_data(os.path.join(fast5, n))) for n in fns], emit="labels")]
    with PrepPool(2, n_slots=3, chunk=2) as pool:
        errors = []
        got = [(n, y1, y2) for n, _, y1, y2 in eng.revise_stream(
            ((fn, w) for fn, w, _ in pool.stream(fast5, fns, prefetch=4)),
            errors=errors, emit="labels")]
    assert not errors and len(got) == len(want) == 12
    for (n, a1, a2), (m, b1, b2) in zip(got, want):
        assert n == m and np.array_equal(a1, b1) and np.array_equal(a2, b2)


def test_read_beyond_slot_caps_travels_pickled(setup):
    _, fast5, names, _ = setup
    sizes = {n: get_read_data(os.path.join(fast5, n)).n_bases for n in names}
    cap = sorted(sizes.values())[2]
    with PrepPool(2, slot_bases=cap, slot_samples=20 * cap) as pool:
        for fn, w, err in pool.stream(fast5, names):
            assert err is None
            in_slot = any(np.shares_memory(w.sig8, s) for s in pool._slot_maps)
            assert in_slot == (sizes[fn] <= cap and w.n_samples <= 20 * cap), fn
            ref = encode_read(compact_read_numpy(get_read_data(
                os.path.join(fast5, fn))))
            assert w.sig8.tobytes() == ref.sig8.tobytes()
            assert w.dur_esc_idx.tobytes() == ref.dur_esc_idx.tobytes()


def test_default_slots_hold_the_default_engines_largest_read(setup):
    from nanoreviser_torch.infer.streaming import DEFAULT_BATCH_WINDOWS

    _, _, _, paths = setup
    eng = StreamingReviser(*paths, batch_windows=DEFAULT_BATCH_WINDOWS, device="cpu")
    assert eng.read_caps == (hostpipe.DEFAULT_SLOT_BASES, hostpipe.DEFAULT_SLOT_SAMPLES)


def test_dev_shm_space_check_raises(monkeypatch):
    real = os.statvfs
    before = set(os.listdir(hostpipe.SLOT_DIR))

    class Small:
        f_bavail, f_frsize, f_blocks = 100, 4096, 100

    monkeypatch.setattr(os, "statvfs", lambda p: Small() if p == hostpipe.SLOT_DIR
                        else real(p))
    with pytest.raises(OSError, match=r"need \d+ bytes of /dev/shm, which has 409600 free"):
        PrepPool(2)
    assert set(os.listdir(hostpipe.SLOT_DIR)) <= before


def test_stale_slot_gc_keeps_live_and_foreign_slots():
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    slot_dir = hostpipe.SLOT_DIR
    dead = os.path.join(slot_dir, f"{hostpipe.SLOT_PREFIX}{child.pid}_0_0")
    live = os.path.join(slot_dir, f"{hostpipe.SLOT_PREFIX}{os.getpid()}_999_0")
    jax_dead = os.path.join(slot_dir, f"nanorev_prep_{child.pid}_0_0")
    for p in (dead, live, jax_dead):
        open(p, "wb").close()
    try:
        hostpipe._gc_stale_slots()
        assert not os.path.exists(dead)
        assert os.path.exists(live) and os.path.exists(jax_dead)
        open(dead, "wb").close()
        jhostpipe._gc_stale_slots()          # the JAX collector: its own only
        assert os.path.exists(dead) and not os.path.exists(jax_dead)
    finally:
        for p in (dead, live, jax_dead):
            try:
                os.unlink(p)
            except OSError:
                pass


def test_workers_import_no_torch_or_jax(setup):
    _, fast5, names, _ = setup
    with PrepPool(2) as pool:
        pool.ready()
        assert len(list(pool.stream(fast5, names))) == len(names)
        loaded = set()
        for _ in range(4):
            loaded |= set(pool._pool.apply(eval, ("list(__import__('sys').modules)",)))
    assert "nanoreviser_torch.signal.host_prep" in loaded
    assert "nanoreviser_torch.infer.wire" in loaded
    bad = [m for m in loaded if m.split(".")[0] in ("torch", "jax", "nanoreviser_tpu")]
    assert not bad, bad


def test_cli_model_mode_failed_read_contract(setup):
    from nanoreviser_torch.cli.reviser import main

    d, fast5, names, paths = setup
    out, failed = d / "cli_out", d / "cli_failed.txt"
    rc = main(["-d", fast5, "-o", str(out), "-F", "fastq", "--revise_mode", "model",
               "--device", "cpu", "--thread", "2",
               "--model1_predict_dir", paths[0], "--model2_predict_dir", paths[1],
               "-e", str(failed)])
    assert rc == 1
    lines = failed.read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith(BAD + "\t")
    assert sorted(os.listdir(out)) == [n.split(".")[0] + "_out.fastq" for n in names]
