"""The port's training step vs the JAX package (CPU, f32, small shapes).

* ``batch_norm_train``: the biased batch moments and the normalized output.
* ``reviser_apply(train=True)`` with dropout off: probs, feature and the BN
  batch statistics.
* ``reviser_loss`` with and without ``sample_weight`` (and a -1 target,
  which both packages index as the last class).
* One whole train step from the same params and batch, dropout off, against
  a JAX reference built here from ``reviser_apply(train=True)``,
  ``reviser_loss``, ``jax.value_and_grad`` and ``keras_adam``: loss within
  rtol 1e-5, every gradient within rtol 1e-4 / atol 1e-6, BN batch moments
  within 1e-5, moving statistics within 1e-6, updated params within 2*lr
  everywhere and within 1e-5 on at least 99% of elements (Adam's first
  step is about lr*sign(g), so a gradient near 0 may flip).
  The reference runs in 64-bit floats (``jax.enable_x64``), and the port's
  step runs twice: in f64, where every bar holds per element, and in f32,
  where the gradient bar is held on each gradient tensor's largest element
  (max |d| <= 1e-6 + 1e-4 * max |g|). Per element it cannot hold in f32:
  near-zero elements of the LSTM input-kernel and bias gradients are sums
  that cancel, and at these shapes f32 rounding moves them by up to 2.2x the
  bar in the port (against its own f64 step) and 2.8x in the JAX package
  (against its x64 step); at batch 512, T = 13 the port's f32 step is 10x
  off in one element.
* The dropout mask keeps ~80% of elements and scales them by 1/0.8.
* ``centers`` is drawn last and the serving path ignores it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nanoreviser_tpu.models.layers import batch_norm_train as jax_bn_train
from nanoreviser_tpu.models.reviser import ReviserConfig as JaxConfig
from nanoreviser_tpu.models.reviser import reviser_apply as jax_apply
from nanoreviser_tpu.train.loss import reviser_loss as jax_loss
from nanoreviser_tpu.train.step import BN_KEYS as JAX_BN_KEYS
from nanoreviser_tpu.train.step import keras_adam as jax_adam
from nanoreviser_torch.models import ReviserConfig, init_reviser_params, reviser_apply
from nanoreviser_torch.models.layers import batch_norm_train
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.train.loss import reviser_loss
from nanoreviser_torch.train.step import (
    BN_KEYS,
    default_class_weights,
    keras_adam,
    make_train_step,
    params_to_torch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


T, B, LR = 5, 24, 1e-3


def _params(n_classes, seed=0, window=T):
    """Port init, with random BN statistics and biases so that every term
    of the step is exercised."""
    gen = torch.Generator().manual_seed(seed)
    p = init_reviser_params(gen, ReviserConfig(window=window, n_classes=n_classes))
    return randomize_inference_stats(p, gen)


def _batch(n_classes, seed=0, pad=5):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[B - pad:] = 0.0                       # pad rows weigh 0
    return {
        "signal": rng.normal(0, 1, (B, T, 50)).astype(np.float32),
        "feats": rng.normal(0.5, 0.3, (B, T, 6)).astype(np.float32),
        "y": rng.integers(0, n_classes, B).astype(np.int32),
        "weight": w,
    }


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, (7, 5, 16)).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 16).astype(np.float32),
         "beta": rng.normal(0, 1, 16).astype(np.float32)}
    yj, sj = jax_bn_train(p, jnp.asarray(x))
    yt, st = batch_norm_train({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-5, atol=1e-5)
    # the biased variance: torch's default (unbiased) would differ by n/(n-1)
    np.testing.assert_allclose(st["var"].numpy(), x.reshape(-1, 16).var(0), rtol=1e-5)


@pytest.mark.parametrize("n_classes", [6, 5])
def test_train_forward_matches_jax(n_classes):
    p = _params(n_classes, seed=n_classes)
    b = _batch(n_classes)
    cfg_j = JaxConfig(window=T, n_classes=n_classes, dropout_rate=0.0)
    pj, sj, fj = jax.jit(lambda p, s, f: jax_apply(p, s, f, train=True, cfg=cfg_j))(
        p, jnp.asarray(b["signal"]), jnp.asarray(b["feats"]))
    cfg = ReviserConfig(window=T, n_classes=n_classes, dropout_rate=0.0)
    pt, ft, st = reviser_apply(params_to_torch(p, "cpu"), torch.from_numpy(b["signal"]),
                               torch.from_numpy(b["feats"]), cfg, train=True)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)
    assert sorted(st) == sorted(fj) == sorted(BN_KEYS)
    for key in BN_KEYS:
        for m in ("mean", "var"):
            np.testing.assert_allclose(st[key][m].detach().numpy(),
                                       np.asarray(fj[key][m]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_matches_jax(weighted):
    rng = np.random.default_rng(2)
    c = 5
    logits = rng.normal(0, 3, (B, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs[0] = [1.0, 0, 0, 0, 0]            # the clip to [1e-7, 1 - 1e-7]
    feature = rng.normal(0, 1, (B, 16)).astype(np.float32)
    centers = rng.uniform(-0.05, 0.05, (c, 16)).astype(np.float32)
    y = rng.integers(0, c, B).astype(np.int32)
    y[1] = -1                                # a reference 'N' in model2's space
    cw = default_class_weights(c)
    w = rng.integers(0, 2, B).astype(np.float32) if weighted else None
    lj, mj = jax_loss(jnp.asarray(probs), jnp.asarray(feature), jnp.asarray(centers),
                      jnp.asarray(y), jnp.asarray(cw),
                      sample_weight=None if w is None else jnp.asarray(w))
    lt, mt = reviser_loss(torch.from_numpy(probs), torch.from_numpy(feature),
                          torch.from_numpy(centers), torch.from_numpy(y),
                          torch.from_numpy(cw),
                          sample_weight=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    for k in ("ce_loss", "center_loss", "accuracy"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6, err_msg=k)


def _jax_step(p, b, n_classes):
    """One JAX train step, built from the package's parts, with its grads,
    in 64-bit floats (module docstring)."""
    cfg = JaxConfig(window=T, n_classes=n_classes, dropout_rate=0.0)
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
    with jax.enable_x64():
        cw = f64(default_class_weights(n_classes))
        params = jax.tree_util.tree_map(f64, p)
        batch = {k: (f64(v) if v.dtype.kind == "f" else jnp.asarray(v))
                 for k, v in b.items()}

        @jax.jit
        def step(params, batch):
            def loss_fn(params):
                probs, feature, stats = jax_apply(
                    params, batch["signal"], batch["feats"], train=True, cfg=cfg)
                loss, _ = jax_loss(probs, feature, params["centers"], batch["y"],
                                   cw, 0.4, sample_weight=batch["weight"])
                return loss, stats

            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            opt = jax_adam(LR)
            updates, _ = opt.update(grads, opt.init(params), params)
            new = optax.apply_updates(params, updates)
            for key in JAX_BN_KEYS:
                for m in ("mean", "var"):
                    new[key][m] = new[key][m] * 0.99 + stats[key][m] * (1 - 0.99)
            return loss, grads, stats, new

        out = jax.tree_util.tree_map(np.asarray, step(params, batch))
    return (float(out[0]),) + tuple(out[1:])


@functools.lru_cache(maxsize=None)
def _step_case(n_classes):
    """(params, batch, JAX step) of one case, shared by both dtypes."""
    p = _params(n_classes, seed=10 + n_classes)
    b = _batch(n_classes, seed=n_classes)
    return p, b, _jax_step(p, b, n_classes)


def _grads_close(got, ref, elementwise: bool) -> bool:
    """The gradient bar, rtol 1e-4 / atol 1e-6: per element, or (f32) on
    the tensor's largest element (module docstring)."""
    d = np.abs(got - ref)
    if elementwise:
        return bool((d <= 1e-6 + 1e-4 * np.abs(ref)).all())
    return float(d.max()) <= 1e-6 + 1e-4 * float(np.abs(ref).max())


@pytest.mark.parametrize("n_classes", [6, 5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_one_train_step_matches_jax(n_classes, dtype):
    p, b, (loss_j, grads_j, stats_j, new_j) = _step_case(n_classes)

    params = params_to_torch(p, "cpu", dtype)
    opt = keras_adam(params, LR)
    assert opt.defaults["eps"] == 1e-7 and opt.defaults["betas"] == (0.9, 0.999)
    step = make_train_step(ReviserConfig(window=T, n_classes=n_classes,
                                         dropout_rate=0.0))
    batch = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in _torch_batch(b).items()}
    metrics, stats = step(params, opt, batch)

    np.testing.assert_allclose(float(metrics["loss"]), loss_j, rtol=1e-5)
    n_el, n_close = 0, 0
    for path, leaf in _leaves(params):
        gj = _at(grads_j, path)
        if path[0] in BN_KEYS and path[-1] in ("mean", "var"):
            assert leaf.grad is None and not leaf.requires_grad
            assert not gj.any()              # JAX's gradient is zero there
            continue
        assert _grads_close(leaf.grad.numpy(), gj, dtype == torch.float64), path
        d = np.abs(leaf.detach().numpy() - _at(new_j, path))
        assert d.max() <= 2 * LR, path
        n_el += d.size
        n_close += int((d <= 1e-5).sum())
    assert n_close >= 0.99 * n_el, (n_close, n_el)
    for key in BN_KEYS:
        for m in ("mean", "var"):
            np.testing.assert_allclose(stats[key][m].numpy(), stats_j[key][m],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(params[key][m].numpy(), new_j[key][m],
                                       rtol=1e-6, atol=1e-6)


def test_dropout_keep_fraction_and_scale():
    p = params_to_torch(_params(6), "cpu")
    cfg = ReviserConfig(window=T, n_classes=6)
    assert cfg.dropout_rate == 0.2
    b = _torch_batch(_batch(6))
    x = None

    def grab(module_dense):
        def wrapped(params, h, activation=None):
            nonlocal x
            if h.shape[-1] == 400:
                x = h.detach().clone()
            return module_dense(params, h, activation)
        return wrapped

    import nanoreviser_torch.models.reviser as rv

    dense = rv.dense
    try:
        rv.dense = grab(dense)
        reviser_apply(p, b["signal"], b["feats"], cfg, train=True,
                      generator=torch.Generator().manual_seed(0))
        dropped = x
        reviser_apply(p, b["signal"], b["feats"],
                      dataclasses.replace(cfg, dropout_rate=0.0), train=True)
        kept_all = x
    finally:
        rv.dense = dense
    zero = dropped == 0
    keep = 1.0 - float(zero.float().mean())
    assert abs(keep - 0.8) < 0.01, keep
    torch.testing.assert_close(dropped[~zero], kept_all[~zero] / 0.8)
    with pytest.raises(ValueError, match="Generator"):
        reviser_apply(p, b["signal"], b["feats"], cfg, train=True)


def test_centers_drawn_last_and_ignored_by_serving(tmp_path):
    from nanoreviser_torch.models import Reviser, load_keras_weights, save_keras_weights
    from nanoreviser_torch.models.fused import fold_inference_params
    from nanoreviser_torch.ops import reviser_kernel as rk

    cfg = ReviserConfig(window=11, n_classes=6)
    gen = torch.Generator().manual_seed(3)
    p = init_reviser_params(gen, cfg)
    after = torch.rand(4, generator=gen, dtype=torch.float64)
    c = p["centers"]
    assert c.shape == (6, 16) and c.dtype == np.float32 and np.abs(c).max() <= 0.05
    # gen is where it would be without centers: the next draws are the ones
    # a generator that drew only the other weights makes
    ref = torch.Generator().manual_seed(3)
    q = init_reviser_params(ref, cfg)
    np.testing.assert_array_equal(torch.rand(4, generator=ref, dtype=torch.float64),
                                  after)
    bare = {k: v for k, v in p.items() if k != "centers"}
    for path, leaf in _leaves(bare):
        np.testing.assert_array_equal(leaf, _at(q, path))

    paths = []
    for tag, tree in (("with", p), ("bare", bare)):
        paths.append(str(tmp_path / f"{tag}.h5"))
        save_keras_weights(tree, paths[-1], 11, 6)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert "centers" not in load_keras_weights(paths[0])[0]
    packed = [rk.pack_stack_weights(fold_inference_params(t), 11) for t in (p, bare)]
    assert packed[0].keys() == packed[1].keys()
    for k in packed[0]:
        np.testing.assert_array_equal(packed[0][k], packed[1][k])
    rng = np.random.default_rng(0)
    sig = torch.tensor(rng.normal(0, 1, (4, 11, 50)), dtype=torch.float32)
    feats = torch.tensor(rng.normal(0.5, 0.3, (4, 11, 6)), dtype=torch.float32)
    torch.testing.assert_close(Reviser(p)(sig, feats)[0], Reviser(bare)(sig, feats)[0],
                               rtol=0, atol=0)
