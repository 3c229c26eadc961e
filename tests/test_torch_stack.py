"""Port reviser stack (ops/reviser_kernel.py) vs the JAX package, CPU.

* The f32 plain version (base_rows_plain + stack_heads_plain on the
  dense-form conv branch) equals JAX ``lstm_stack_apply(signal_branch_apply(...))`` within
  1e-5 (f32 both sides; only summation order and the conv's dense form
  differ).
* The bf16 plain version (what the CPU wrapper runs, and what the CUDA
  kernel stack_full is held against on the card) agrees with the TPU kernel
  ``stack_logits_full`` in interpret mode at the JAX package's own bars
  (tests/test_reviser_kernel.py): argmax >= 0.99 and atol 0.15, for logits
  and max-probs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nanoreviser_tpu.models import init_reviser_params as jax_init
from nanoreviser_tpu.models.fused import lstm_stack_apply as jax_stack
from nanoreviser_tpu.models.fused import signal_branch_apply as jax_branch
from nanoreviser_tpu.models.reviser import ReviserConfig as JaxConfig
from nanoreviser_tpu.ops import reviser_kernel as jrk
from nanoreviser_torch.models.fused import fold_inference_params
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.ops import reviser_kernel as rk
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

T = 11


def _fused_pair(seed):
    out = []
    for k, n_cls in enumerate((6, 5)):
        p = jax_init(jax.random.PRNGKey(seed + k),
                     JaxConfig(window=T, n_classes=n_cls))
        p = jax.tree_util.tree_map(np.asarray, p)
        p = randomize_inference_stats(p, torch.Generator().manual_seed(seed + k))
        out.append(fold_inference_params(p))
    return out


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    sig = rng.normal(0, 1, (n, 50)).astype(np.float32)
    sig[rng.random((n, 50)) < 0.05] = 0.0
    feats = np.stack([
        rng.choice([250, 180, 100, 30], n) / 300.0,
        rng.normal(1.0, 0.1, n), rng.normal(1.0, 0.2, n),
        rng.integers(2, 30, n) / 10.0,
        rng.normal(0.0, 1.0, n), rng.normal(0.5, 0.2, n),
    ], axis=1).astype(np.float32)
    return sig, feats


def _packed(fused):
    return rk.stack_models([rk.pack_stack_weights(f, T) for f in fused])


def test_pack_layout_matches_shapes():
    fused = _fused_pair(0)
    ws = _packed(fused)
    for k, shape in rk.stack_shapes(T).items():
        assert ws[k].shape == (2,) + shape, k
    assert set(rk.stack_shapes(T)) == set(ws)
    # every row-major weight reaches the kernels, packed or as is;
    # stack_windows reads stack_full's weights less the conv branch's
    packed_from = {"cw1", "cw2", "cc", "ce", "wi1", "wi3s", "wh1", "wi2", "wh2",
                   "wi3", "wh3", "wi4", "wh4", "d1w", "d2w", "mow"}
    assert set(ws) == (set(rk.FULL_ORDER) - set(rk.FULL_SHAPES)) | packed_from
    # kernel_weights holds every weight stack_windows reads, in the type,
    # shape and layout its C entry takes, one pointer per weight and model
    ptrs = rk._weight_ptrs(rk.kernel_weights(ws, "cpu"), rk.CORE_ORDER, T,
                           per_model=True)
    assert len(set(ptrs)) == len(ptrs) == 2 * len(rk.CORE_ORDER)
    # model 2's padded class can never win
    assert ws["fob"][1, 5] == rk.PAD_LOGIT_BIAS and not ws["fow"][1, :, 5].any()
    # conv dense form equals the JAX package's
    cd = rk.conv_dense_form(fused[0])
    cdj = jrk.conv_dense_form(fused[0])
    for k in cd:
        np.testing.assert_array_equal(cd[k], cdj[k])


def test_f32_plain_matches_jax_model():
    fused = _fused_pair(1)
    n_win, w_valid = 96, 80
    sig, feats = _rows(n_win + T, seed=2)
    ws = rk.weights_to_device(_packed(fused), "cpu", torch.float32)
    logits, probs = rk.stack_logits_plain(
        ws, torch.from_numpy(sig), torch.from_numpy(feats), t_len=T,
        w_valid=w_valid, n_windows=n_win, want_probs=True, bf16=False)
    idx = np.arange(w_valid)[:, None] + np.arange(T)[None, :]
    for m, f in enumerate(fused):
        want = np.asarray(jax_stack(
            f, jnp.asarray(feats[idx]),
            jax_branch(f, jnp.asarray(sig[idx]), JaxConfig(window=T))))
        n_cls = want.shape[1]
        got = logits[m, :w_valid, :n_cls].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        sm = jax.nn.softmax(jnp.asarray(want), -1).max(-1)
        np.testing.assert_allclose(probs[m, :w_valid].numpy(), np.asarray(sm),
                                   atol=1e-6, rtol=1e-5)
    assert not logits[:, w_valid:].any() and not probs[:, w_valid:].any()


def test_bf16_plain_matches_tpu_kernel_interpret():
    fused = _fused_pair(2)
    n_win, block = 256, 128
    sig, feats = _rows(n_win + T, seed=3)
    sig_bf = torch.from_numpy(sig).to(torch.bfloat16)
    sig64 = torch.nn.functional.pad(sig_bf, (0, rk.QP - 50))
    ws_np = _packed(fused)
    ws = rk.weights_to_device(ws_np, "cpu")
    got_l, got_p = rk.stack_logits_full(
        ws, sig64, torch.from_numpy(feats), t_len=T, w_valid=n_win,
        want_probs=True)

    jws = jrk.stack_weight_dicts([jrk.pack_stack_weights(f, T) for f in fused])
    sig_nb = jnp.pad(jnp.asarray(sig), ((0, 0), (0, 78))).astype(jnp.bfloat16)
    feats_nb = jnp.pad(jnp.asarray(feats), ((0, 0), (0, 122))).astype(jnp.bfloat16)
    want_l, want_p = jrk.stack_logits_full(
        jws, sig_nb, feats_nb, t_len=T, block=block, interpret=True,
        want_probs=True, w_valid=jnp.int32(n_win))
    want_l, want_p = np.asarray(want_l), np.asarray(want_p)
    gl = got_l.numpy()
    for m in range(2):
        agree = (gl[m].argmax(1) == want_l[m].argmax(1)).mean()
        assert agree >= 0.99, (m, agree)
    np.testing.assert_allclose(gl, want_l, atol=0.15)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=0.15)
    # the logits actually vary across windows (the check is not vacuous)
    assert gl[0].std(0).min() > 1e-3


def test_wrapper_on_cpu_is_the_bf16_plain_version():
    fused = _fused_pair(3)
    sig, feats = _rows(40 + T, seed=4)
    sig64 = torch.nn.functional.pad(torch.from_numpy(sig), (0, 14)).to(torch.bfloat16)
    ws = rk.weights_to_device(_packed(fused), "cpu")
    before = rk.STACK_FULL.launches
    a = rk.stack_logits_full(ws, sig64, torch.from_numpy(feats), t_len=T,
                             w_valid=32, want_probs=False)
    b = rk.stack_logits_plain(ws, sig64, torch.from_numpy(feats), t_len=T,
                              w_valid=32, n_windows=40, want_probs=False,
                              bf16=True)
    assert torch.equal(a[0], b[0]) and a[1] is None
    assert rk.STACK_FULL.launches == before
