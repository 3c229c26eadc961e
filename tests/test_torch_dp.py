"""Data-parallel training over processes vs one process and the JAX package.

Two worker processes (this file run as a script: gloo on localhost, one torch
thread each, ``--device cpu``) are launched once for the module. Each
trains on its slice of the same global batches, and the tests read what
they wrote:

* BN over a distributed mesh (f64, [8, T, 16] split in two): outputs,
  moments and input gradients equal one process's to 1e-12;
* one train step (f64, dropout on, a batch whose pad rows all fall on
  rank 1): loss, BN moments, every gradient and every param equal one
  process's within the per-element bar of tests/test_torch_train_step.py
  (rtol 1e-4, atol 1e-6);
* ``train_model``, 2 epochs at T = 5 and batch 32 on 100 windows (the
  last batch padded): both ranks' params bit-identical; per-epoch
  ``loss``/``val_loss`` within 1e-3 relative of one port process with
  dropout on, and, dropout off in both packages (patched in ``train.loop``
  as tests/test_torch_train_loop.py does), of the JAX package's
  ``train_model(mesh=make_mesh())`` over the 8 CPU devices of
  tests/conftest.py.

Also: ``local_batch_slice`` equals the JAX package's, the backend rule,
and a mesh of one process trains bit-identically to no mesh.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import nanoreviser_torch.train.loop as port_loop
from nanoreviser_torch.dist import local_batch_slice
from nanoreviser_torch.models import ReviserConfig, init_reviser_params
from nanoreviser_torch.models.layers import batch_norm_train
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.parallel import choose_backend, make_mesh, shard_params
from nanoreviser_torch.train.step import (
    is_trained, keras_adam, make_train_step, param_leaves, params_to_torch)
from tests.torch_threads import one_torch_thread, use_one_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, BATCH, N_WINDOWS, WORLD = 5, 32, 100, 2
STEP_WEIGHT = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float64)   # rank 1: 3 pads


def _slice(mesh, n):
    if mesh is None or not mesh.distributed:
        return slice(0, n)
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _bn_run(mesh) -> dict:
    """BN of a [8, T, 16] f64 batch (this process's rows), backward of a
    random linear function of its output."""
    rng = np.random.default_rng(11)
    x, r = rng.normal(0.3, 1.5, (2, 8, T, 16))
    p = {"gamma": torch.tensor(rng.uniform(0.5, 1.5, 16), requires_grad=True),
         "beta": torch.tensor(rng.normal(0, 0.3, 16), requires_grad=True)}
    sl = _slice(mesh, len(x))
    xt = torch.tensor(x[sl], requires_grad=True)
    y, st = batch_norm_train(p, xt, mesh=mesh)
    (y * torch.from_numpy(r[sl])).sum().backward()
    return {"bn/y": y.detach().numpy(), "bn/mean": st["mean"].detach().numpy(),
            "bn/var": st["var"].detach().numpy(), "bn/dx": xt.grad.numpy(),
            "bn/dgamma": p["gamma"].grad.numpy(), "bn/dbeta": p["beta"].grad.numpy()}


def _step_run(mesh) -> dict:
    """One f64 train step, dropout on, on this process's rows of an
    8-window batch whose 3 pad rows lie in rank 1's half."""
    cfg = ReviserConfig(window=T, n_classes=6)
    gen = torch.Generator().manual_seed(7)
    p = randomize_inference_stats(init_reviser_params(gen, cfg), gen)
    params = params_to_torch(p, "cpu", torch.float64)
    opt = keras_adam(params)
    rng = np.random.default_rng(12)
    batch = {"signal": rng.normal(0, 1, (8, T, 50)), "feats": rng.normal(0.5, 0.3, (8, T, 6)),
             "y": rng.integers(0, 6, 8), "weight": STEP_WEIGHT}
    denom = max(float(batch["weight"].sum()), 1.0)
    if mesh is not None:
        batch = local_batch_slice(batch, mesh.rank, mesh.world)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    metrics, stats = make_train_step(cfg, mesh=mesh)(
        params, opt, batch, torch.Generator().manual_seed(3),
        denominator=denom if mesh is not None else None)
    out = {f"step/{k}": v.numpy() for k, v in metrics.items()}
    for key, s in stats.items():
        for m, v in s.items():
            out[f"stats/{key}/{m}"] = v.numpy()
    for path, leaf in param_leaves(params):
        out["param/" + "/".join(path)] = leaf.detach().numpy()
        if is_trained(path):
            out["grad/" + "/".join(path)] = leaf.grad.numpy()
    return out


def _loop_data(seed=0):
    rng = np.random.default_rng(seed)
    n = N_WINDOWS + T
    x = rng.normal(0.5, 0.3, (n, 6)).astype(np.float32)
    sig = rng.normal(0, 1, (n, 50)).astype(np.float32)
    y = rng.integers(0, 6, (N_WINDOWS, 1)).astype(np.int32)
    return x, sig, y


def _loop_kwargs():
    init = init_reviser_params(torch.Generator().manual_seed(7),
                               ReviserConfig(window=T, n_classes=6))
    return dict(n_classes=6, window=T, epochs=2, batch_size=BATCH,
                validation_split=0.1, seed=5, init_params=init, verbose=False,
                steps_per_dispatch=1)


def _loop_run(mesh, dropout: bool) -> dict:
    """Two epochs of the port's ``train_model``; dropout off by patching
    ``train.loop``'s ``ReviserConfig``."""
    tag = "loop" if dropout else "loop0"
    saved = port_loop.ReviserConfig
    if not dropout:
        port_loop.ReviserConfig = functools.partial(ReviserConfig, dropout_rate=0.0)
    try:
        params, hist = port_loop.train_model(
            *_loop_data(), mesh=mesh, device=None if mesh else "cpu", **_loop_kwargs())
    finally:
        port_loop.ReviserConfig = saved
    out = {f"{tag}/hist/{k}": np.asarray(v) for k, v in hist.items()}
    for path, leaf in param_leaves(params):
        out[f"{tag}/param/" + "/".join(path)] = leaf
    return out


def _all_runs(mesh) -> dict:
    return {**_bn_run(mesh), **_step_run(mesh), **_loop_run(mesh, True),
            **_loop_run(mesh, False)}


def _worker(coord: str, world: int, rank: int, out_dir: str) -> None:
    from nanoreviser_torch import dist

    use_one_thread()
    dist.initialize(coord, world, rank)
    mesh = make_mesh("cpu")
    res = _all_runs(mesh)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fp:
        json.dump({"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend,
                   "device": str(mesh.device)}, fp)
    dist.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, rank 1's, one process's on the global batches)."""
    out = tmp_path_factory.mktemp("dp")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(WORLD), str(k), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(WORLD)]
    try:
        one = _all_runs(None)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(out / f"rank{k}.npz")) for k in range(WORLD)]
    meta = [json.loads((out / f"rank{k}.json").read_text()) for k in range(WORLD)]
    assert [m["rank"] for m in meta] == [0, 1]
    assert all(m["backend"] == "gloo" and m["device"] == "cpu" for m in meta)
    return ranks[0], ranks[1], one


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_local_batch_slice_matches_jax(world):
    from nanoreviser_tpu.dist import local_batch_slice as jax_slice

    rng = np.random.default_rng(world)
    batch = {"signal": rng.normal(size=(12, T, 50)), "y": rng.integers(0, 6, 12),
             "weight": np.ones(12, np.float32)}
    for k in range(world):
        got, want = local_batch_slice(batch, k, world), jax_slice(batch, k, world)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


def test_backend_rule():
    a, b = ("hostA", "cuda:0"), ("hostA", "cuda:1")
    assert choose_backend([a, b], "cuda") == "nccl"
    assert choose_backend([a, ("hostB", "cuda:0")], "cuda") == "nccl"
    assert choose_backend([a, a], "cuda") == "gloo"          # two ranks, one card
    assert choose_backend([a, b, a], "cuda") == "gloo"
    assert choose_backend([("hostA", "cpu"), ("hostB", "cpu")], "cpu") == "gloo"


def test_one_process_mesh_is_the_local_path():
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.distributed) == (0, 1, None, False)
    p = shard_params(init_reviser_params(torch.Generator().manual_seed(1),
                                         ReviserConfig(window=T)), mesh)
    assert p["dense1"]["w"].device == mesh.device and p["dense1"]["w"].requires_grad
    assert not p["bn_c1"]["mean"].requires_grad
    a, ha = port_loop.train_model(*_loop_data(1), mesh=mesh, **_loop_kwargs())
    b, hb = port_loop.train_model(*_loop_data(1), device="cpu", **_loop_kwargs())
    assert ha == hb
    for (pa, la), (pb, lb) in zip(param_leaves(a), param_leaves(b)):
        assert pa == pb
        np.testing.assert_array_equal(la, lb)


def _cat(r0, r1, key):
    return np.concatenate([r0[key], r1[key]])


def test_bn_reduced_moments_equal_one_process(runs):
    r0, r1, one = runs
    for key in ("bn/y", "bn/dx"):
        np.testing.assert_allclose(_cat(r0, r1, key), one[key], rtol=0, atol=1e-12)
    for key in ("bn/mean", "bn/var"):
        np.testing.assert_array_equal(r0[key], r1[key])
        np.testing.assert_allclose(r0[key], one[key], rtol=0, atol=1e-12)
    for key in ("bn/dgamma", "bn/dbeta"):      # each rank's share of the sum
        np.testing.assert_allclose(r0[key] + r1[key], one[key], rtol=0, atol=1e-12)


def test_train_step_equals_one_process(runs):
    r0, r1, one = runs
    keys = [k for k in one if k.split("/")[0] in ("step", "stats", "grad", "param")]
    assert any(k.startswith("grad/") for k in keys) and "step/loss" in keys
    for key in keys:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
        np.testing.assert_allclose(r0[key], one[key], rtol=1e-4, atol=1e-6, err_msg=key)
    # the pad rows change the result: rank 1's half holds 1 of 5 weights
    assert float(one["step/loss"]) > 0


def test_train_model_two_processes_equal_one(runs):
    r0, r1, one = runs
    for tag in ("loop", "loop0"):
        params = [k for k in one if k.startswith(f"{tag}/param/")]
        assert len(params) > 60
        for key in params:                       # replicas stay bit-identical
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
        for k in ("loss", "val_loss", "accuracy", "val_accuracy"):
            key = f"{tag}/hist/{k}"
            assert len(one[key]) == 2 and np.isfinite(one[key]).all()
            np.testing.assert_array_equal(r0[key], r1[key])
        for k in ("loss", "val_loss"):
            key = f"{tag}/hist/{k}"
            np.testing.assert_allclose(r0[key], one[key], rtol=1e-3, err_msg=key)


def test_train_model_two_processes_follow_jax_mesh(runs, monkeypatch):
    import nanoreviser_tpu.train.loop as jax_loop
    from nanoreviser_tpu.models.reviser import ReviserConfig as JaxConfig
    from nanoreviser_tpu.parallel import make_mesh as jax_mesh

    r0, _, _ = runs
    monkeypatch.setattr(jax_loop, "ReviserConfig",
                        functools.partial(JaxConfig, dropout_rate=0.0))
    mesh = jax_mesh()
    assert mesh.devices.size == 8
    _, jh = jax_loop.train_model(*_loop_data(), mesh=mesh, **_loop_kwargs())
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(r0[f"loop0/hist/{k}"], jh[k], rtol=1e-3, err_msg=k)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
