"""The port's pre-gathered-window path vs the JAX package, on the CPU.

The path: windowed host prep (``signal.host_prep.prep_read_numpy``) ->
``signal.device_prep.device_preprocess_batch`` -> the conv branch
(``models.fused.signal_branch_apply``) -> ``ops.reviser_kernel.
stack_logits_multi`` (the TPU kernel ``_kernel``; on the CPU its bf16 plain
version) -> merge. Inputs come from numpy with a seed (synthetic fast5 reads
from ``io.synthetic``), weights from the JAX init with randomized biases and
BN statistics, folded, at T=11. Tolerances:

* host prep, segmentation, features and the device finishing step:
  identical arrays (``assert_array_equal``);
* the f32 plain stack: within 1e-5 of JAX ``stack_logits_reference`` (f32
  both sides; only summation order differs);
* the bf16 CPU wrapper against the TPU kernel in interpret mode: argmax
  agreement >= 0.99 and atol 0.15 for logits and max probs (the JAX
  package's own bars, tests/test_reviser_kernel.py:34-36);
* the whole windowed path: the port's composition gives the same merged
  sequence as the JAX host-oracle composition (tests/test_streaming.py:
  56-93), labels agreeing >= 0.99; the bf16 windowed path's labels agree
  >= 0.99 with the JAX windowed path's (TPU kernel in interpret mode) and
  >= 0.98 with the f32 labels.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanoreviser_tpu.infer.merge as jmerge
import nanoreviser_tpu.io as jio
import nanoreviser_tpu.signal.host_prep as jprep
from nanoreviser_tpu.models import init_reviser_params as jax_init
from nanoreviser_tpu.models.fused import lstm_stack_apply as jax_stack
from nanoreviser_tpu.models.fused import signal_branch_apply as jax_branch
from nanoreviser_tpu.models.reviser import ReviserConfig as JaxConfig
from nanoreviser_tpu.ops import reviser_kernel as jrk
from nanoreviser_tpu.signal import device_prep as jdev
from nanoreviser_tpu.signal import features as jfeat
from nanoreviser_tpu.signal import segmentation as jseg
import nanoreviser_torch.infer.merge as tmerge
import nanoreviser_torch.io as tio
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.models import ReviserConfig, params_from_numpy
from nanoreviser_torch.models.fused import (
    fold_inference_params, fused_forward, signal_branch_apply)
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.ops import build
from nanoreviser_torch.ops import reviser_kernel as rk
from nanoreviser_torch.signal import (
    assemble_features, base_colors, base_labels, device_preprocess_batch,
    features, mad_normalizers, prep_read, prep_read_numpy, segment_signal)
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


def _window_inputs(n, seed):
    rng = np.random.default_rng(seed)
    feats = np.stack([
        rng.choice([250, 180, 100, 30], (n, T)) / 300.0,
        rng.normal(1.0, 0.1, (n, T)), rng.normal(1.0, 0.2, (n, T)),
        rng.integers(2, 30, (n, T)) / 10.0,
        rng.normal(0.0, 1.0, (n, T)), rng.normal(0.5, 0.2, (n, T)),
    ], axis=-1).astype(np.float32)
    sig = rng.normal(0, 1, (2, n, T, 64)).astype(np.float32)
    return feats, sig


def _tail_truncated(rd, extra):
    """The read with its signal cut ``extra`` samples after the last base
    start, so the last windows clamp at the tail (vlen < 50)."""
    end = rd.read_start_rel_to_raw + int(rd.starts[-1]) + extra
    return dataclasses.replace(rd, signal=rd.signal[:end])


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast5w")
    names = write_synthetic_dir(d, 3, (250, 420), seed=11)
    out = []
    for n in names:
        path = os.path.join(d, n)
        out.append((tio.get_read_data(path), jio.get_read_data(path)))
    # one read whose tail ends 10 samples past its last base start
    out.append((_tail_truncated(out[0][0], 10), _tail_truncated(out[0][1], 10)))
    return out


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_host_segmentation_features_and_prep_identical(reads):
    for name in ("BASE_COLOR_TABLE", "BASE_LABEL_TABLE", "LABEL_TO_BASE"):
        np.testing.assert_array_equal(getattr(features, name), getattr(jfeat, name))
    vlens = []
    for rt, rj in reads:
        tail = rt.signal[rt.read_start_rel_to_raw :]
        assert mad_normalizers(tail) == jseg.mad_normalizers(tail)
        last_dur = int(rt.lengths[-1])
        st, sj = segment_signal(tail, rt.starts, last_dur), jseg.segment_signal(
            tail, rj.starts, last_dur)
        _assert_fields_equal(st, sj)
        np.testing.assert_array_equal(base_colors(rt.bases), jfeat.base_colors(rj.bases))
        np.testing.assert_array_equal(base_labels(rt.bases), jfeat.base_labels(rj.bases))
        durations = np.concatenate([np.diff(rt.starts), [last_dur]])
        args = (durations, rt.ab_mean, rt.ab_std, st.shift, st.scale)
        ft = assemble_features(rt.bases, st.event_mean, st.event_std, *args)
        fj = jfeat.assemble_features(rj.bases, sj.event_mean, sj.event_std, *args)
        assert ft.dtype == fj.dtype == np.float32
        np.testing.assert_array_equal(ft, fj)
        pt = prep_read_numpy(rt)
        _assert_fields_equal(pt, jprep.prep_read_numpy(rj))
        # prep_read runs the host library, which zeroes the pad columns
        # where numpy has neighbouring samples: equal inside each valid span
        pn = prep_read(rt)
        left = (50 - pt.vlen.astype(np.int32) + 1) // 2
        cols = np.arange(50)[None, :]
        span = (cols >= left[:, None]) & (cols < (left + pt.vlen)[:, None])
        np.testing.assert_array_equal(pn.win[span], pt.win[span])
        assert not pn.win[~span].any()
        _assert_fields_equal(dataclasses.replace(pn, win=pt.win), pt)
        vlens.append(pt.vlen)
    # edge windows are exercised at both ends of a read
    assert all(v[0] < 50 for v in vlens) and vlens[-1][-1] < 50


def test_device_preprocess_batch_bit_exact(reads):
    prepped = [prep_read_numpy(rt) for rt, _ in reads[:2]]
    n_pad = sum(p.n_bases for p in prepped) + 53
    win = np.zeros((n_pad, 50), np.int16)
    vlen = np.zeros(n_pad, np.uint8)
    feats_in = np.zeros((n_pad, 6), np.float16)
    shift_b = np.zeros(n_pad, np.float32)
    scale_b = np.ones(n_pad, np.float32)
    off = 0
    for p in prepped:
        n = p.n_bases
        win[off : off + n] = p.win
        vlen[off : off + n] = p.vlen
        feats_in[off : off + n] = p.feats
        shift_b[off : off + n] = p.shift
        scale_b[off : off + n] = p.scale
        off += n
    arrs = (win, vlen, feats_in, shift_b, scale_b)
    wt, ft = device_preprocess_batch(*map(torch.from_numpy, arrs))
    wj, fj = jdev.device_preprocess_batch(*map(jnp.asarray, arrs))
    assert wt.dtype == ft.dtype == torch.float32
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert not wt[off:].any()
    # and the host reference of each read within f32 division rounding
    off = 0
    for rt, _ in reads[:2]:
        n = rt.n_bases
        seg = segment_signal(rt.signal[rt.read_start_rel_to_raw :], rt.starts,
                             int(rt.lengths[-1]))
        np.testing.assert_allclose(wt[off : off + n].numpy(), seg.windows, atol=2e-5)
        off += n


def test_f32_windows_plain_matches_jax_reference():
    fused = _fused_pair(21)
    feats, sig = _window_inputs(72, seed=22)
    ws = rk.weights_to_device(rk.stack_models(
        [rk.pack_stack_weights(f, T) for f in fused]), "cpu", torch.float32)
    logits, probs = rk.stack_windows_plain(
        ws, torch.from_numpy(feats), torch.from_numpy(sig), t_len=T,
        want_probs=True, bf16=False)
    for m, f in enumerate(fused):
        want = np.asarray(jrk.stack_logits_reference(f, feats, sig[m]))
        n_cls = want.shape[1]
        np.testing.assert_allclose(logits[m, :, :n_cls].numpy(), want,
                                   atol=1e-5, rtol=1e-5)
        sm = np.asarray(jax.nn.softmax(jnp.asarray(want), -1).max(-1))
        np.testing.assert_allclose(probs[m].numpy(), sm, atol=1e-6, rtol=1e-5)
        # the port's own reference delegates to its f32 model
        ref = rk.stack_logits_reference(params_from_numpy(f), feats, sig[m])
        np.testing.assert_allclose(ref.numpy(), want, atol=1e-5, rtol=1e-5)


def test_bf16_wrappers_match_tpu_kernel_interpret():
    fused = _fused_pair(31)
    b, block = 128, 128
    feats, sig = _window_inputs(b, seed=32)
    ws = rk.weights_to_device(rk.stack_models(
        [rk.pack_stack_weights(f, T) for f in fused]), "cpu")
    got_l, got_p = rk.stack_logits_multi(
        ws, torch.from_numpy(feats), torch.from_numpy(sig), t_len=T,
        want_probs=True)
    one_l, one_p = rk.stack_logits_single(
        {k: v[0] for k, v in ws.items()}, torch.from_numpy(feats),
        torch.from_numpy(sig[0]), t_len=T, want_probs=True)

    packed = [jrk.pack_stack_weights(f, T) for f in fused]
    jws = jrk.stack_weight_dicts(packed)
    want_l, want_p = jrk.stack_logits_multi(
        jws, jnp.asarray(feats), jnp.asarray(sig), t_len=T, block=block,
        interpret=True, want_probs=True)
    want_one = np.asarray(jrk.stack_logits_pallas(
        packed[0], jnp.asarray(feats), jnp.asarray(sig[0]), t_len=T,
        block=block, interpret=True))
    want_l, want_p = np.asarray(want_l), np.asarray(want_p)
    gl = got_l.numpy()
    for m in range(2):
        agree = (gl[m].argmax(1) == want_l[m].argmax(1)).mean()
        assert agree >= 0.99, (m, agree)
    np.testing.assert_allclose(gl, want_l, atol=0.15)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=0.15)
    assert (one_l.numpy().argmax(1) == want_one.argmax(1)).mean() >= 0.99
    np.testing.assert_allclose(one_l.numpy(), want_one, atol=0.15)
    np.testing.assert_allclose(one_p.numpy(), want_p[0], atol=0.15)
    # the logits actually vary across windows (the check is not vacuous)
    assert gl[0].std(0).min() > 1e-3 and gl[1, :, :5].std(0).min() > 1e-3


def _jax_oracle_labels(fused, rd):
    """tests/test_streaming.py:56-93 without its engine: exact host
    segmentation and features -> JAX f32 conv branch + stack, per model."""
    tail = rd.signal[rd.read_start_rel_to_raw :]
    last_dur = int(rd.lengths[-1])
    seg = jseg.segment_signal(tail, rd.starts, last_dur)
    durations = np.concatenate([np.diff(rd.starts), [last_dur]])
    feats = jfeat.assemble_features(
        rd.bases, seg.event_mean, seg.event_std, durations,
        rd.ab_mean, rd.ab_std, seg.shift, seg.scale)
    idx = np.arange(rd.n_bases - T)[:, None] + np.arange(T)[None, :]
    sigw, featw = jnp.asarray(seg.windows[idx]), jnp.asarray(feats[idx])
    return [np.asarray(jnp.argmax(jax_stack(
        f, featw, jax_branch(f, sigw, JaxConfig(window=T))), -1)) for f in fused]


def _port_oracle_labels(fused_t, rd):
    """The same composition in the port, f32."""
    tail = rd.signal[rd.read_start_rel_to_raw :]
    last_dur = int(rd.lengths[-1])
    seg = segment_signal(tail, rd.starts, last_dur)
    durations = np.concatenate([np.diff(rd.starts), [last_dur]])
    feats = assemble_features(rd.bases, seg.event_mean, seg.event_std,
                              durations, rd.ab_mean, rd.ab_std, seg.shift,
                              seg.scale)
    idx = np.arange(rd.n_bases - T)[:, None] + np.arange(T)[None, :]
    sigw = torch.from_numpy(seg.windows[idx])
    featw = torch.from_numpy(feats[idx])
    cfg = ReviserConfig(window=T)
    out = []
    for f in fused_t:
        probs = fused_forward(f, sigw, featw, cfg)
        logits = rk.stack_logits_reference(
            f, featw, signal_branch_apply(f, sigw, cfg))
        assert torch.equal(probs.argmax(-1), logits.argmax(-1))
        out.append(logits.argmax(-1).numpy())
    return out


def _port_windowed_labels(ws, fused_t, rd):
    """The pre-gathered-window path as it runs on the card: windowed prep,
    device finishing, conv branch, stack_logits_multi (bf16; the plain
    version on the CPU)."""
    p = prep_read_numpy(rd)
    windows, feats = device_preprocess_batch(
        torch.from_numpy(p.win), torch.from_numpy(p.vlen),
        torch.from_numpy(p.feats), torch.full((p.n_bases,), p.shift),
        torch.full((p.n_bases,), p.scale))
    idx = torch.arange(p.n_bases - T)[:, None] + torch.arange(T)[None, :]
    sigw, featw = windows[idx], feats[idx]
    cfg = ReviserConfig(window=T)
    sig_outs = torch.stack([signal_branch_apply(f, sigw, cfg) for f in fused_t])
    logits = rk.stack_logits_multi(ws, featw.contiguous(), sig_outs, t_len=T)
    return [logits[0].argmax(-1).numpy(), logits[1, :, :5].argmax(-1).numpy()]


def _jax_windowed_labels(fused, rd, block=128):
    """The JAX package's pre-gathered-window path: windowed prep, device
    finishing, conv branch, the TPU kernel ``stack_logits_multi`` in
    interpret mode (windows padded to a whole block)."""
    p = jprep.prep_read_numpy(rd)
    windows, feats = jdev.device_preprocess_batch(
        jnp.asarray(p.win), jnp.asarray(p.vlen), jnp.asarray(p.feats),
        jnp.full(p.n_bases, p.shift, jnp.float32),
        jnp.full(p.n_bases, p.scale, jnp.float32))
    n_win = p.n_bases - T
    idx = np.arange(n_win)[:, None] + np.arange(T)[None, :]
    sigw, featw = windows[idx], feats[idx]
    sig_outs = jnp.stack([jax_branch(f, sigw, JaxConfig(window=T)) for f in fused])
    pad = -n_win % block
    jws = jrk.stack_weight_dicts([jrk.pack_stack_weights(f, T) for f in fused])
    logits = np.asarray(jrk.stack_logits_multi(
        jws, jnp.pad(featw, ((0, pad), (0, 0), (0, 0))),
        jnp.pad(sig_outs, ((0, 0), (0, pad), (0, 0), (0, 0))), t_len=T,
        block=block, interpret=True))[:, :n_win]
    return [logits[0].argmax(-1), logits[1, :, :5].argmax(-1)]


def test_windowed_path_end_to_end_matches_jax(reads):
    fused = _fused_pair(41)
    fused_t = [params_from_numpy(f) for f in fused]
    ws = rk.weights_to_device(rk.stack_models(
        [rk.pack_stack_weights(f, T) for f in fused]), "cpu")
    rt, rj = reads[2]
    assert 250 <= rt.n_bases < 420
    yj = _jax_oracle_labels(fused, rj)
    yt = _port_oracle_labels(fused_t, rt)
    for a, b in zip(yt, yj):
        assert np.mean(a == b) >= 0.99
    off_j, _ = jmerge.calibrate_center_offset(rj.bases, yj[0], T)
    off_t, _ = tmerge.calibrate_center_offset(rt.bases, yt[0], T)
    assert off_t == off_j
    seq_j = jmerge.merge_revision(rj.bases, yj[0], yj[1], align="center",
                                  window=T, center_offset=off_j)
    seq_t = tmerge.merge_revision(rt.bases, yt[0], yt[1], align="center",
                                  window=T, center_offset=off_t)
    assert seq_t == seq_j
    assert len(np.unique(yt[0])) > 1
    # the windowed path as it runs on the card (f16 features, bf16 stack)
    # against the JAX package's windowed path with the TPU kernel, and
    # against the f32 labels: bf16 rounding flips ~1% of windows, so that
    # bar is 0.98, the one the engine's card-vs-f32 labels are held to
    yw = _port_windowed_labels(ws, fused_t, rt)
    yjw = _jax_windowed_labels(fused, rj)
    for a, b, c in zip(yw, yjw, yj):
        assert np.mean(a == b) >= 0.99, np.mean(a == b)
        assert np.mean(a == c) >= 0.98, np.mean(a == c)


def test_cpu_wrappers_launch_no_kernel():
    fused = _fused_pair(51)
    feats, sig = _window_inputs(37, seed=52)
    ws = rk.weights_to_device(rk.stack_models(
        [rk.pack_stack_weights(f, T) for f in fused]), "cpu")
    kernels = (rk.STACK_FULL, rk.STACK_WINDOWS)
    before = [k.launches for k in kernels]
    f, s = torch.from_numpy(feats), torch.from_numpy(sig)
    got = rk.stack_logits_multi(ws, f, s, t_len=T)
    one = rk.stack_logits_single({k: v[1] for k, v in ws.items()}, f, s[1],
                                 t_len=T)
    assert [k.launches for k in kernels] == before
    want, _ = rk.stack_windows_plain(ws, f, s, t_len=T, want_probs=False,
                                     bf16=True)
    assert torch.equal(got, want) and torch.equal(one, want[1])
    assert rk.STACK_WINDOWS.replaces == "nanoreviser_tpu/ops/reviser_kernel.py:251"
    assert isinstance(rk.STACK_WINDOWS, build.Kernel)
    with pytest.raises(ValueError, match="models"):
        rk.stack_logits_multi({k: v[:1] for k, v in ws.items()}, f, s, t_len=T)


def test_executed_mac_counts_match_jax():
    for t in (11, 13):
        got = rk.executed_mac_counts(t)
        want = jrk.executed_mac_counts(t)
        assert {k: got[k] for k in want} == want
    c = rk.executed_mac_counts(11)
    assert c["per_window"] == 5_477_568
    assert c["per_window_pregathered"] == 6_206_912
