"""Port weights and eager model vs the JAX package (CPU, f32).

The JAX ``init_reviser_params`` with randomized biases and BN statistics
goes through ``save_keras_weights`` and is loaded by both packages; the
port's eager ``reviser_apply`` probs and the folded ``lstm_stack_apply``
logits must equal JAX's within 1e-5 (f32 on both sides, summation order
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanoreviser_tpu.models import init_reviser_params as jax_init
from nanoreviser_tpu.models import load_keras_weights as jax_load
from nanoreviser_tpu.models import reviser_apply as jax_apply
from nanoreviser_tpu.models.export_keras import save_keras_weights as jax_save
from nanoreviser_tpu.models.fused import fold_inference_params as jax_fold
from nanoreviser_tpu.models.fused import lstm_stack_apply as jax_stack
from nanoreviser_tpu.models.fused import signal_branch_apply as jax_branch
from nanoreviser_tpu.models.reviser import ReviserConfig as JaxConfig
from nanoreviser_torch.models import (
    ReviserConfig,
    Reviser,
    init_reviser_params,
    load_keras_weights,
    params_from_numpy,
    reviser_apply,
    save_keras_weights,
)
from nanoreviser_torch.models.fused import (
    fold_inference_params,
    lstm_stack_apply,
    signal_branch_apply,
)
from nanoreviser_torch.models.reviser import randomize_inference_stats
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-5


def _jax_params(window, n_classes, seed):
    p = jax_init(jax.random.PRNGKey(seed),
                 JaxConfig(window=window, n_classes=n_classes))
    p = jax.tree_util.tree_map(np.asarray, p)
    return randomize_inference_stats(p, torch.Generator().manual_seed(seed))


def _inputs(window, batch=24, seed=0):
    rng = np.random.default_rng(seed)
    sig = rng.normal(0, 1, (batch, window, 50)).astype(np.float32)
    feats = rng.normal(0.5, 0.3, (batch, window, 6)).astype(np.float32)
    return sig, feats


@pytest.mark.parametrize("window,n_classes", [(11, 6), (13, 5)])
def test_h5_roundtrip_and_eager_forward(tmp_path, window, n_classes):
    params = _jax_params(window, n_classes, seed=window)
    path = tmp_path / "m.h5"
    jax_save(params, str(path), window, n_classes)
    pj, wj, cj = jax_load(path)
    pt, wt, ct = load_keras_weights(path)
    assert (wt, ct) == (wj, cj) == (window, n_classes)
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    flat_t = jax.tree_util.tree_leaves_with_path(pt)
    assert [k for k, _ in flat_j] == [k for k, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)

    sig, feats = _inputs(window)
    probs_j, feat_j = jax_apply(pj, jnp.asarray(sig), jnp.asarray(feats))
    for tree in (params_from_numpy(pt), params_from_numpy(pj)):
        probs_t, feat_t = reviser_apply(tree, torch.from_numpy(sig),
                                        torch.from_numpy(feats))
        np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j),
                                   atol=TOL, rtol=TOL)
    mod = Reviser(pt)
    probs_m, _ = mod(torch.from_numpy(sig), torch.from_numpy(feats))
    np.testing.assert_allclose(probs_m.numpy(), np.asarray(probs_j),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [11, 13])
def test_folded_stack_logits(window):
    params = _jax_params(window, 6, seed=100 + window)
    fj = jax_fold(params)
    ft = fold_inference_params(params)
    for k in ("read_rnn2", "total_rnn1", "total_rnn2"):
        for d in ("fwd", "bwd"):
            for w in ("wi", "wh", "b"):
                np.testing.assert_array_equal(ft[k][d][w], fj[k][d][w])
    sig, feats = _inputs(window, seed=1)
    cfg_j = JaxConfig(window=window, n_classes=6)
    lj = np.asarray(jax_stack(fj, jnp.asarray(feats),
                              jax_branch(fj, jnp.asarray(sig), cfg_j)))
    tt = params_from_numpy(ft)
    lt = lstm_stack_apply(
        tt, torch.from_numpy(feats),
        signal_branch_apply(tt, torch.from_numpy(sig),
                            ReviserConfig(window=window)))
    np.testing.assert_allclose(lt.numpy(), lj, atol=TOL, rtol=TOL)


def test_port_init_is_keras_like_and_saves(tmp_path):
    cfg = ReviserConfig(window=11, n_classes=5)
    p = init_reviser_params(torch.Generator().manual_seed(0), cfg)
    wh = p["total_rnn1"]["fwd"]["wh"]                      # [128, 512]
    np.testing.assert_allclose(wh @ wh.T, np.eye(128), atol=1e-5)
    assert (p["read_rnn1"]["fwd"]["b"][16:32] == 1).all()
    lim = np.sqrt(6.0 / (400 + 64))
    assert np.abs(p["sig_dense"]["w"]).max() <= lim
    p2 = init_reviser_params(torch.Generator().manual_seed(0), cfg)
    np.testing.assert_array_equal(p2["dense1"]["w"], p["dense1"]["w"])
    save_keras_weights(p, str(tmp_path / "m.h5"), 11, 5)
    q, w, c = jax_load(tmp_path / "m.h5")
    assert (w, c) == (11, 5)
    np.testing.assert_array_equal(q["feature"]["w"], p["feature"]["w"])
