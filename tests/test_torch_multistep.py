"""K train steps per dispatch (``make_multi_step``, ``chunked``,
``train_model(steps_per_dispatch=K)``) vs eager steps and the JAX package
(CPU, T = 5, batch 16, K <= 4).

* ``make_multi_step`` on the CPU is K eager steps bit for bit, dropout on,
  from the same generator.
* Against the JAX package's ``make_multi_step`` (a ``lax.scan`` of K steps
  in one ``jit``), dropout off, in 64-bit floats (x64, as
  tests/test_torch_train_step.py builds its JAX step): per-step loss within
  rtol 1e-5 and accuracy within 1e-6, then every param within 2*lr and
  >= 99% of elements within 1e-5, the moving statistics within 1e-6 (that
  file's one-step bars, held after K steps).
* ``chunked`` gives the counts and stacks of the JAX loop's rule on epochs
  whose step count is not a multiple of K (the JAX loop run with its steps
  replaced by recorders and ``jit`` by the identity, so that it calls them
  once per dispatch).
* ``train_model(steps_per_dispatch=3)`` equals ``steps_per_dispatch=1`` bit
  for bit, dropout on, over 2 epochs of 7 steps (stacks 3, 3, 1).
* A checkpoint whose Adam groups are ``capturable`` (as graphed steps on
  the card write them) resumes on the CPU as the eager one does.
* A distributed mesh keeps one eager step per batch, with the global
  batch's denominator, and builds no multi-step (the step and the
  all-reduce replaced by recorders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanoreviser_torch.train.loop as port_loop
import nanoreviser_tpu.train.loop as jax_loop
from nanoreviser_torch.models import ReviserConfig, init_reviser_params
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.train import data as port_data
from nanoreviser_torch.train.step import (
    BN_KEYS,
    is_trained,
    keras_adam,
    make_multi_step,
    make_train_step,
    param_leaves,
    params_to_torch,
)
from nanoreviser_tpu.models.reviser import ReviserConfig as JaxConfig
from nanoreviser_tpu.train.step import keras_adam as jax_adam
from nanoreviser_tpu.train.step import make_multi_step as jax_make_multi_step
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


T, B, LR = 5, 16, 1e-3


def _params(n_classes=6, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = init_reviser_params(gen, ReviserConfig(window=T, n_classes=n_classes))
    return randomize_inference_stats(p, gen)


def _stack(k, n_classes=6, seed=0):
    """K batches stacked [K, B, ...], each with 3 pad rows."""
    rng = np.random.default_rng(seed)
    w = np.ones((k, B), np.float32)
    w[:, B - 3:] = 0.0
    return {"signal": rng.normal(0, 1, (k, B, T, 50)).astype(np.float32),
            "feats": rng.normal(0.5, 0.3, (k, B, T, 6)).astype(np.float32),
            "y": rng.integers(0, n_classes, (k, B)).astype(np.int64),
            "weight": w}


def _torch(stack, dtype=torch.float32):
    return {k: (torch.from_numpy(v).to(dtype) if v.dtype.kind == "f"
                else torch.from_numpy(v)) for k, v in stack.items()}


def test_multi_step_on_cpu_is_k_eager_steps():
    cfg = ReviserConfig(window=T, n_classes=6)
    assert cfg.dropout_rate > 0
    p, k = _params(), 3
    stack = _torch(_stack(k))
    pa, pb = params_to_torch(p, "cpu"), params_to_torch(p, "cpu")
    oa, ob = keras_adam(pa, LR), keras_adam(pb, LR)
    ga, gb = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    got = make_multi_step(cfg)(pa, oa, stack, ga)
    step = make_train_step(cfg)
    want = [step(pb, ob, {key: v[i] for key, v in stack.items()}, gb)[0]
            for i in range(k)]
    for m in ("loss", "accuracy"):
        assert got[m].shape == (k,)
        assert torch.equal(got[m], torch.stack([w[m] for w in want])), m
    for (path, a), (_, b) in zip(param_leaves(pa), param_leaves(pb)):
        assert torch.equal(a, b), path
    # the generators stand at the same place
    assert torch.equal(torch.rand(4, generator=ga), torch.rand(4, generator=gb))


def _jax_multi(p, stack, n_classes, k):
    """The JAX package's make_multi_step on the same params and stacks, x64."""
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
    with jax.enable_x64():
        multi, opt = jax_make_multi_step(
            JaxConfig(window=T, n_classes=n_classes, dropout_rate=0.0),
            optimizer=jax_adam(LR))
        params = jax.tree_util.tree_map(f64, p)
        batches = {key: (f64(v) if v.dtype.kind == "f" else jnp.asarray(v))
                   for key, v in stack.items()}
        rngs = jax.random.split(jax.random.PRNGKey(0), k)
        new, _, metrics = multi(params, opt.init(params), batches, rngs)
        return (jax.tree_util.tree_map(np.asarray, new),
                {key: np.asarray(v) for key, v in metrics.items()})


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("n_classes", [6, 5])
def test_multi_step_matches_jax_multi_step(n_classes):
    p, k = _params(n_classes, seed=n_classes), 3
    stack = _stack(k, n_classes, seed=n_classes)
    new_j, metrics_j = _jax_multi(p, stack, n_classes, k)

    params = params_to_torch(p, "cpu", torch.float64)
    cfg = ReviserConfig(window=T, n_classes=n_classes, dropout_rate=0.0)
    metrics = make_multi_step(cfg)(params, keras_adam(params, LR),
                                   _torch(stack, torch.float64))
    assert metrics_j["loss"].shape == metrics["loss"].shape == (k,)
    np.testing.assert_allclose(metrics["loss"].numpy(), metrics_j["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics["accuracy"].numpy(), metrics_j["accuracy"],
                               rtol=0, atol=1e-6)
    n_el = n_close = 0
    for path, leaf in param_leaves(params):
        d = np.abs(leaf.detach().numpy() - _at(new_j, path))
        if not is_trained(path):
            assert path[0] in BN_KEYS
            assert (d <= 1e-6 + 1e-6 * np.abs(_at(new_j, path))).all(), path
            continue
        assert d.max() <= 2 * LR, path
        n_el += d.size
        n_close += int((d <= 1e-5).sum())
    assert n_close >= 0.99 * n_el, (n_close, n_el)


class _NoJit:
    """The ``jax`` module with ``jit`` the identity."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **_):
        return fn


def _loop_data(n_windows=100, seed=0):
    rng = np.random.default_rng(seed)
    n = n_windows + T
    return (rng.normal(0.5, 0.3, (n, 6)).astype(np.float32),
            rng.normal(0, 1, (n, 50)).astype(np.float32),
            rng.integers(0, 6, (n_windows, 1)).astype(np.int32))


@pytest.mark.parametrize("k", [3, 4])
def test_chunked_follows_jax_rule(monkeypatch, k):
    """100 windows at batch 16, no validation: 7 steps, stacks of k and
    the batches left over alone."""
    calls = []

    def train_step(cfg, optimizer=None, **_):
        def step(params, opt_state, batch, rng):
            calls.append((1, batch))
            return params, opt_state, {"loss": np.float32(0), "accuracy": np.float32(0)}
        return step, optimizer

    def multi_step(cfg, optimizer=None, **_):
        def multi(params, opt_state, batches, rngs):
            calls.append((len(rngs), batches))
            z = np.zeros(len(rngs), np.float32)
            return params, opt_state, {"loss": z, "accuracy": z}
        return multi, optimizer

    monkeypatch.setattr(jax_loop, "make_train_step", train_step)
    monkeypatch.setattr(jax_loop, "make_multi_step", multi_step)
    monkeypatch.setattr(jax_loop, "jax", _NoJit())
    x, sig, y = _loop_data()
    init = init_reviser_params(torch.Generator().manual_seed(7),
                               ReviserConfig(window=T, n_classes=6))
    jax_loop.train_model(x, sig, y, n_classes=6, window=T, epochs=1, batch_size=B,
                         validation_split=0.0, seed=5, init_params=init,
                         verbose=False, steps_per_dispatch=k)
    it = port_data.BatchIterator(x, sig, y, B, 0.0, 5, window=T)
    got = list(port_loop.chunked(it.epoch(), k))
    assert it.steps_per_epoch == 7 and 7 % k
    assert [c for c, _ in got] == [c for c, _ in calls] == [k] * (7 // k) + [1] * (7 % k)
    for (count, stack), (_, want) in zip(got, calls):
        assert stack.keys() == want.keys()
        for key in stack:
            assert stack[key].shape[0] == count
            np.testing.assert_array_equal(stack[key] if count > 1 else stack[key][0],
                                          want[key])


def _train(k, **kw):
    x, sig, y = _loop_data(n_windows=120)
    init = init_reviser_params(torch.Generator().manual_seed(7),
                               ReviserConfig(window=T, n_classes=6))
    args = dict(n_classes=6, window=T, epochs=2, batch_size=B, validation_split=0.1,
                seed=5, init_params=init, verbose=False, device="cpu",
                steps_per_dispatch=k)
    return port_loop.train_model(x, sig, y, **dict(args, **kw))


def test_train_model_k_steps_equal_one_step_bit_for_bit(monkeypatch):
    """108 training windows: 7 steps an epoch, dispatched 3, 3, 1."""
    seen = []
    real = port_loop.make_multi_step

    def counting(*a, **kw):
        multi = real(*a, **kw)

        def call(params, optimizer, batches, generator=None):
            seen.append(len(batches["y"]))
            return multi(params, optimizer, batches, generator)
        return call

    monkeypatch.setattr(port_loop, "make_multi_step", counting)
    pk, hk = _train(3)
    assert seen == [3, 3, 1] * 2
    seen.clear()
    p1, h1 = _train(1)
    assert seen == [1] * 14
    assert hk == h1 and len(h1["loss"]) == 2
    assert np.isfinite(h1["loss"]).all()
    for (path, a), (_, b) in zip(param_leaves(pk), param_leaves(p1)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_checkpoint_of_capturable_adam_resumes_on_cpu(tmp_path):
    """A checkpoint whose Adam groups say ``capturable`` (graphed steps on
    the card write it) resumes on the CPU as the same checkpoint written
    eagerly does; Adam's step counter carries on."""
    eager, graphed = str(tmp_path / "eager.pt"), str(tmp_path / "graphed.pt")
    _train(3, epochs=1, checkpoint_path=eager)
    ck = port_loop.load_checkpoint(eager)
    assert not any(g["capturable"] for g in ck["opt_state"]["param_groups"])
    ck["opt_state"]["param_groups"] = [dict(g, capturable=True)
                                       for g in ck["opt_state"]["param_groups"]]
    torch.save(ck, graphed)
    runs = [_train(3, checkpoint_path=path, resume=True) for path in (eager, graphed)]
    assert runs[0][1] == runs[1][1] and len(runs[0][1]["loss"]) == 1
    for (path, a), (_, b) in zip(param_leaves(runs[0][0]), param_leaves(runs[1][0])):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    saved = port_loop.load_checkpoint(graphed)["opt_state"]
    assert not any(g["capturable"] for g in saved["param_groups"])
    assert all(float(s["step"]) == 14 for s in saved["state"].values())


def test_distributed_mesh_keeps_one_eager_step_per_batch(monkeypatch):
    from nanoreviser_torch.parallel import Mesh

    mesh = Mesh(group=None, rank=0, world=2, device=torch.device("cpu"),
                backend="gloo")
    calls = []

    def train_step(cfg, mesh=None, **_):
        assert mesh is not None and mesh.distributed

        def step(params, optimizer, batch, generator=None, denominator=None):
            calls.append((len(batch["y"]), denominator))
            z = torch.zeros(())
            return {"loss": z, "accuracy": z}, {}
        return step

    def no_multi_step(*_, **__):
        raise AssertionError("a multi-step built across processes")

    monkeypatch.setattr(port_loop, "make_train_step", train_step)
    monkeypatch.setattr(port_loop, "make_multi_step", no_multi_step)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda *_, **__: None)
    x, sig, y = _loop_data()
    _, hist = port_loop.train_model(
        x, sig, y, n_classes=6, window=T, epochs=1, batch_size=B,
        validation_split=0.1, seed=5, verbose=False, mesh=mesh, steps_per_dispatch=4)
    # 90 training windows: 5 full global batches of 16, then 10 and 6 pads
    assert calls == [(B // 2, 16.0)] * 5 + [(B // 2, 10.0)]
    assert len(hist["loss"]) == 1

