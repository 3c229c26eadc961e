"""The port's training data and loop vs the JAX package (CPU).

* ``load_training_corpus`` and ``BatchIterator`` give identical arrays and
  identical batches (the same permutation from the same seed).
* Two epochs of ``train_model`` at T = 5, batch 32, on 100 windows, at one
  step per dispatch, and at 4 (batch 16), dropout off on both sides (each package's ``ReviserConfig`` in ``train.loop``
  patched to ``dropout_rate=0``; nothing in the JAX package changes): the
  per-epoch ``loss`` and ``val_loss`` agree within 1e-3 relative.
* Resume from the port's checkpoint, and ``.npz`` weights read across
  packages.
"""

import functools

import numpy as np
import pytest
import torch

import nanoreviser_torch.train.loop as port_loop
import nanoreviser_tpu.train.loop as jax_loop
from nanoreviser_torch.models import ReviserConfig, init_reviser_params
from nanoreviser_torch.train import data as port_data
from nanoreviser_tpu.models.reviser import ReviserConfig as JaxConfig
from nanoreviser_tpu.train import data as jax_data
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


T, BATCH = 5, 32


def _fake_npz(d, n_reads=3, seed=0):
    """Reference-layout per-read caches, as tests/test_train_data.py."""
    rng = np.random.default_rng(seed)
    for r in range(n_reads):
        n = int(rng.integers(40, 80))
        np.savez(
            d / f"read{r}.npz",
            refvals=rng.integers(0, 6, n), refvals2=rng.integers(1, 6, n),
            readVals=rng.choice([250, 180, 100, 30], n),
            signal_mean=rng.normal(600, 40, n), signal_std=rng.normal(20, 4, n),
            signal_len=rng.integers(3, 30, n), ab_mean=rng.normal(0, 1, n),
            ab_std=rng.normal(1, 0.2, n), signal_x=rng.normal(0, 1, (n, 50)),
            mapvals=np.array(["M"] * n), starts=np.arange(n) * 9,
            scale=54.0, shift=687.0,
        )


@pytest.mark.parametrize("window", [5, 13])
def test_corpus_and_batches_identical_to_jax(tmp_path, window):
    _fake_npz(tmp_path)
    pc = port_data.load_training_corpus(str(tmp_path), window)
    jc = jax_data.load_training_corpus(str(tmp_path), window)
    for f in ("feats", "signal", "y", "y2"):
        a, b = getattr(pc, f), getattr(jc, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
    for x, y in zip(pc.materialize(), jc.materialize()):
        np.testing.assert_array_equal(x, y)
    kw = dict(batch_size=BATCH, validation_split=0.1, seed=3, window=window)
    pi = port_data.BatchIterator(pc.feats, pc.signal, pc.y, **kw)
    ji = jax_data.BatchIterator(jc.feats, jc.signal, jc.y, **kw)
    assert pi.steps_per_epoch == ji.steps_per_epoch
    for _ in range(2):                      # two epochs: two permutations
        for phase in ("epoch", "validation"):
            n = 0
            for a, b in zip(getattr(pi, phase)(), getattr(ji, phase)()):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
                n += 1
            assert n > 0


def _data(seed=0, n_windows=100):
    rng = np.random.default_rng(seed)
    n = n_windows + T
    x = rng.normal(0.5, 0.3, (n, 6)).astype(np.float32)
    sig = rng.normal(0, 1, (n, 50)).astype(np.float32)
    y = rng.integers(0, 6, (n_windows, 1)).astype(np.int32)
    return x, sig, y


def _init(n_classes=6, seed=7):
    return init_reviser_params(torch.Generator().manual_seed(seed),
                               ReviserConfig(window=T, n_classes=n_classes))


@pytest.mark.parametrize("k, batch", [(1, BATCH), (4, 16)])
def test_train_model_follows_jax(monkeypatch, k, batch):
    """At K steps per dispatch in both loops; at K = 4 the batch is 16, so
    that an epoch of 6 steps holds a stack of 4 and 2 left over."""
    monkeypatch.setattr(port_loop, "ReviserConfig",
                        functools.partial(ReviserConfig, dropout_rate=0.0))
    monkeypatch.setattr(jax_loop, "ReviserConfig",
                        functools.partial(JaxConfig, dropout_rate=0.0))
    x, sig, y = _data()
    kw = dict(n_classes=6, window=T, epochs=2, batch_size=batch,
              validation_split=0.1, seed=5, init_params=_init(), verbose=False,
              steps_per_dispatch=k)
    pp, ph = port_loop.train_model(x, sig, y, device="cpu", **kw)
    jp, jh = jax_loop.train_model(x, sig, y, **kw)
    assert list(ph) == list(jh)
    for k in ("loss", "val_loss", "accuracy", "val_accuracy"):
        assert len(ph[k]) == len(jh[k]) == 2
        assert np.isfinite(ph[k]).all()
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-3)
    np.testing.assert_allclose(ph["val_loss"], jh["val_loss"], rtol=1e-3)
    assert ph["loss"][1] < ph["loss"][0]
    # after 6 or 12 Adam steps the params still agree to a few steps' worth
    for k in ("dense1", "final_out"):
        assert np.abs(pp[k]["w"] - np.asarray(jp[k]["w"])).max() < 1e-3


def test_resume_from_checkpoint(tmp_path):
    x, sig, y = _data(seed=1)
    ck = str(tmp_path / "ck.pt")
    kw = dict(n_classes=6, window=T, batch_size=BATCH, validation_split=0.1,
              verbose=False, checkpoint_path=ck, device="cpu")
    params, hist = port_loop.train_model(x, sig, y, epochs=2, **kw)
    assert len(hist["loss"]) == 2
    saved = port_loop.load_checkpoint(ck)
    assert saved["epoch"] == 2
    steps = -(-90 // BATCH)
    assert all(float(s["step"]) == 2 * steps for s in saved["opt_state"]["state"].values())

    # at the last epoch already: nothing runs, the checkpoint's params return
    params2, hist2 = port_loop.train_model(x, sig, y, epochs=2, resume=True, **kw)
    assert hist2["loss"] == []
    np.testing.assert_array_equal(params2["dense1"]["w"], params["dense1"]["w"])
    # one more epoch continues Adam from its saved state
    _, hist3 = port_loop.train_model(x, sig, y, epochs=3, resume=True, **kw)
    assert len(hist3["loss"]) == 1
    state = port_loop.load_checkpoint(ck)["opt_state"]["state"]
    assert port_loop.load_checkpoint(ck)["epoch"] == 3
    assert all(float(s["step"]) == 3 * steps for s in state.values())


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


def test_params_npz_read_across_packages(tmp_path):
    p = _init(5)
    port_loop.save_params_npz(p, str(tmp_path / "port.npz"))
    jax_loop.save_params_npz(p, str(tmp_path / "jax.npz"))
    want = list(_leaves(p))
    for got in (port_loop.load_params_npz(str(tmp_path / "jax.npz")),
                jax_loop.load_params_npz(str(tmp_path / "port.npz"))):
        got = list(_leaves(got))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_train_model_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, sig, y = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_loop.train_model(x, sig, y, n_classes=6, window=T, epochs=1,
                              batch_size=BATCH, verbose=False)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        port_loop.train_model(x, sig, y, n_classes=6, window=T, epochs=1,
                              batch_size=BATCH, verbose=False, device="cpu",
                              mesh=object())
