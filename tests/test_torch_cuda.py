"""CUDA kernels vs their plain versions, on the card (marker ``cuda``).

These tests need an NVIDIA GPU with nvcc and skip without one. On the card:

    python -m pytest tests/test_torch_cuda.py -q

They hold the window gather bit-exact against its plain version (rows of
vlen 0, 50..63 and masked values, rows_valid not a multiple of 4, lanes
50..63 zero), the two reviser-stack kernels against the bf16 plain versions
(max |dlogit| <= 0.05, argmax agreement >= 0.995; both at T = 11 and 13;
stack_full over a w_valid that ends inside a block of 16 windows, with the
windows past it left at zero, and w_valid = 0; the pre-gathered-window
kernel from kernel_weights, also for one model, equal to model 1 of two,
and for batches that end inside a block of 16 windows), and the engine's
labels on the card against the
CPU engine's f32 labels (agreement >= 0.98), at small sizes; and they check
that the engine's device step never makes the host wait for the card.
For training, one train step on the card against the CPU (the bars of
tests/test_torch_train_step.py), a step and a batch upload that never make
the host wait, and the aligner's torch DP on the card against the host
library's (identical ops, j_start and score). K steps per dispatch
(``make_multi_step``): replays of a 4-step and a 1-step CUDA graph against
eager steps from the same params and generator seed, dropout on; a
checkpoint of graphed steps resumed on the CPU and back on the card; a
graphed call that never makes the host wait.
"""

import numpy as np
import pytest
import torch

from nanoreviser_torch.ops import reviser_kernel as rk
from nanoreviser_torch.ops.window_gather import window_gather, window_gather_plain

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _weights(seed, t=11):
    from nanoreviser_torch.models import ReviserConfig, init_reviser_params
    from nanoreviser_torch.models.fused import fold_inference_params
    from nanoreviser_torch.models.reviser import randomize_inference_stats

    per_model = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(seed + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=t, n_classes=nc)), gen)
        per_model.append(rk.pack_stack_weights(fold_inference_params(p), t))
    return rk.stack_models(per_model)


def test_gather_kernel_bit_exact():
    dev = _card()
    rng = np.random.default_rng(0)
    n, s = 1000, 20000
    sig = torch.tensor(rng.integers(-2000, 2000, s), dtype=torch.int16, device=dev)
    p0 = np.sort(rng.integers(-30, s, n))
    # pieces that cross either end of the buffer take the clamped path
    p0[:4], p0[-4:] = [-60, -49, -8, -1], [s - 60, s - 49, s - 10, s - 1]
    pos0 = torch.tensor(p0, dtype=torch.int32, device=dev)
    # vlen 1..50, then rows of vlen 0 and of 50..63 and masked values (& 63)
    vl = rng.integers(1, 51, n)
    vl[::7] = 0
    vl[3::11] = rng.integers(50, 64, len(vl[3::11]))
    vl[5::13] = rng.integers(64, 200, len(vl[5::13]))
    vlen = torch.tensor(vl, dtype=torch.int32, device=dev)
    rid = torch.tensor(rng.integers(0, 7, n), dtype=torch.int32, device=dev)
    shift = torch.tensor(rng.uniform(400, 500, 256), dtype=torch.float32, device=dev)
    scale = torch.tensor(rng.uniform(5, 50, 256), dtype=torch.float32, device=dev)
    for rows_valid in (900, 901, 998, n):          # a warp writes 4 rows
        args = (sig, pos0, vlen, rid, shift, scale, rows_valid)
        got = window_gather(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, window_gather_plain(*args))
        assert not got[rows_valid:].any() and not got[:, 50:].any()
        assert not got[:rows_valid][vlen[:rows_valid] == 0].any()
        full = (vlen[:rows_valid] & 63) >= 50
        assert bool(full.any()) and bool((got[:rows_valid][full][:, :50] != 0).all())


@pytest.mark.parametrize("t", [11, 13])
def test_stack_full_matches_bf16_plain(t):
    dev = _card()
    ws = rk.kernel_weights(_weights(5, t), dev)
    rng = np.random.default_rng(1)
    n_win = 700
    n = n_win + t
    sig = torch.tensor(rng.normal(0, 1, (n, 64)), dtype=torch.float32)
    sig[:, 50:] = 0
    sig = sig.to(torch.bfloat16).to(dev)
    feats = torch.tensor(rng.normal(0.5, 0.3, (n, 6)), dtype=torch.float32, device=dev)
    w_valid = 650                                 # not a multiple of 16
    before = rk.STACK_FULL.launches
    lg, pr = rk.stack_logits_full(ws, sig, feats, t_len=t, w_valid=w_valid,
                                  n_windows=n_win, want_probs=True)
    lp, pp = rk.stack_logits_plain(ws, sig, feats, t_len=t, w_valid=w_valid,
                                   n_windows=n_win, want_probs=True, bf16=True)
    torch.cuda.synchronize()
    assert rk.STACK_FULL.launches == before + 1
    for m, nc in enumerate((6, 5)):
        assert float((lg[m, :w_valid, :nc] - lp[m, :w_valid, :nc]).abs().max()) <= 0.05
        agree = (lg[m, :w_valid].argmax(-1) == lp[m, :w_valid].argmax(-1)).float().mean()
        assert float(agree) >= 0.995
    assert float((pr[:, :w_valid] - pp[:, :w_valid]).abs().max()) <= 0.05
    assert not lg[:, w_valid:].any() and not pr[:, w_valid:].any()
    assert float(lg[0, :w_valid].std(0).min()) > 1e-3
    # no window: nothing launched, all zero
    z, zp = rk.stack_logits_full(ws, sig, feats, t_len=t, w_valid=0,
                                 n_windows=n_win, want_probs=True)
    assert rk.STACK_FULL.launches == before + 1
    assert not z.any() and not zp.any() and z.shape == (2, n_win, 6)


def _window_inputs(dev, n, seed, t=11):
    rng = np.random.default_rng(seed)
    feats = torch.tensor(rng.normal(0.5, 0.3, (n, t, 6)), dtype=torch.float32,
                         device=dev)
    sig = torch.tensor(rng.normal(0, 1, (2, n, t, 64)), dtype=torch.float32,
                       device=dev)
    return feats, sig


@pytest.mark.parametrize("t", [11, 13])
def test_windows_kernel_matches_bf16_plain(t):
    dev = _card()
    ws = rk.kernel_weights(_weights(7, t), dev)
    n = 700                                       # not a multiple of 16
    feats, sig = _window_inputs(dev, n, 2, t)
    before = rk.STACK_WINDOWS.launches
    lg, pr = rk.stack_logits_multi(ws, feats, sig, t_len=t, want_probs=True)
    lp, pp = rk.stack_windows_plain(ws, feats, sig, t_len=t, want_probs=True,
                                    bf16=True)
    torch.cuda.synchronize()
    assert rk.STACK_WINDOWS.launches == before + 1
    for m, nc in enumerate((6, 5)):
        assert float((lg[m, :, :nc] - lp[m, :, :nc]).abs().max()) <= 0.05
        agree = (lg[m].argmax(-1) == lp[m].argmax(-1)).float().mean()
        assert float(agree) >= 0.995
    assert float((pr - pp).abs().max()) <= 0.05
    assert float(lg[0].std(0).min()) > 1e-3


def test_windows_kernel_single_model_and_ragged_batches():
    dev = _card()
    ws = rk.kernel_weights(_weights(8), dev)
    for n in (5, 16, 33):                         # below, at and past a block
        feats, sig = _window_inputs(dev, n, n)
        both = rk.stack_logits_multi(ws, feats, sig, t_len=11)
        one = rk.stack_logits_single({k: v[0] for k, v in ws.items()}, feats,
                                     sig[0], t_len=11)
        plain, _ = rk.stack_windows_plain(ws, feats, sig, t_len=11,
                                          want_probs=False, bf16=True)
        torch.cuda.synchronize()
        assert torch.equal(one, both[0])
        assert float((both[:, :, :5] - plain[:, :, :5]).abs().max()) <= 0.05
    # the kernel reads the packed weights only, and has no ring for T > 13
    assert [rk.windows_ring_slots(t) for t in (11, 13, 14)] == [8, 4, 0]
    with pytest.raises(ValueError, match="kernel_weights"):
        rk.stack_logits_multi(rk.weights_to_device(_weights(8), dev), feats, sig,
                              t_len=11)
    feats, sig = _window_inputs(dev, 5, 1, t=14)
    with pytest.raises(ValueError, match="T=14"):
        rk.stack_logits_multi(rk.kernel_weights(_weights(8, 14), dev), feats, sig,
                              t_len=14)


def _engine_inputs(tmp_path):
    """(weight paths, [(name, ReadData)]) of 4 synthetic reads."""
    import os

    from nanoreviser_torch.io import get_read_data
    from nanoreviser_torch.io.synthetic import write_synthetic_dir
    from nanoreviser_torch.models import (
        ReviserConfig, init_reviser_params, save_keras_weights)
    from nanoreviser_torch.models.reviser import randomize_inference_stats

    names = write_synthetic_dir(tmp_path / "f5", 4, (800, 1500), seed=3)
    paths = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(40 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=11, n_classes=nc)), gen)
        paths.append(str(tmp_path / f"m{k}.h5"))
        save_keras_weights(p, paths[-1], 11, nc)
    return paths, [(n, get_read_data(os.path.join(tmp_path, "f5", n))) for n in names]


def test_engine_on_card_matches_cpu_engine(tmp_path):
    _card()
    from nanoreviser_torch.infer import StreamingReviser

    paths, reads = _engine_inputs(tmp_path)
    got = {n: y for n, _, y, _ in StreamingReviser(
        *paths, batch_windows=2048, device="cuda").revise_stream(reads, emit="labels")}
    want = {n: y for n, _, y, _ in StreamingReviser(
        *paths, batch_windows=2048, device="cpu").revise_stream(reads, emit="labels")}
    agree = np.mean(np.concatenate([got[n] == want[n] for n, _ in reads]))
    assert agree >= 0.98


def test_device_step_never_waits_for_the_device(tmp_path):
    """Decode, gather, stack, argmax and phred only queue work on the card,
    so the host packs the next batch while this one runs."""
    _card()
    from nanoreviser_torch.infer import StreamingReviser
    from nanoreviser_torch.infer.wire import encode_read, wire_to_tensors
    from nanoreviser_torch.signal import compact_read_numpy

    paths, reads = _engine_inputs(tmp_path)
    eng = StreamingReviser(*paths, batch_windows=2048, emit_quality=True,
                           device="cuda")
    packed, tier, n = eng.pack_batch(
        [(name, encode_read(compact_read_numpy(rd))) for name, rd in reads])
    assert n >= 1
    v = wire_to_tensors(packed, eng.device)
    step = (v, tier, int(packed["wvalid"][0]), int(packed["nv"][0]))
    want = eng._device_step(*step)              # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng._device_step(*step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _train_case(n_classes, t=13, b=128, seed=0):
    """Numpy params (randomized BN statistics) and a batch with pad rows."""
    from nanoreviser_torch.models import ReviserConfig, init_reviser_params
    from nanoreviser_torch.models.reviser import randomize_inference_stats

    gen = torch.Generator().manual_seed(seed + n_classes)
    p = randomize_inference_stats(
        init_reviser_params(gen, ReviserConfig(window=t, n_classes=n_classes)), gen)
    rng = np.random.default_rng(seed)
    w = np.ones(b, np.float32)
    w[-7:] = 0.0
    batch = {"signal": rng.normal(0, 1, (b, t, 50)).astype(np.float32),
             "feats": rng.normal(0.5, 0.3, (b, t, 6)).astype(np.float32),
             "y": rng.integers(-1, n_classes, b).astype(np.int64), "weight": w}
    return p, batch


def _run_step(p, batch, n_classes, dev, dtype, t=13):
    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.step import keras_adam, make_train_step, params_to_torch

    params = params_to_torch(p, dev, dtype)
    opt = keras_adam(params, 1e-3)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()}
    metrics, stats = make_train_step(ReviserConfig(window=t, n_classes=n_classes,
                                                   dropout_rate=0.0))(params, opt, tb)
    return metrics, stats, params


@pytest.mark.parametrize("n_classes", [6, 5])
def test_train_step_on_card_matches_cpu(n_classes):
    """One step from the same params and batch, dropout and TF32 off, at
    T = 13: in f64 every bar per element; in f32 the gradient bar on each
    tensor's largest element (tests/test_torch_train_step.py says why)."""
    from nanoreviser_torch.train.step import BN_KEYS, param_leaves

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, batch = _train_case(n_classes)
    for dtype in (torch.float64, torch.float32):
        mc, sc, pc = _run_step(p, batch, n_classes, "cpu", dtype)
        mg, sg, pg = _run_step(p, batch, n_classes, dev, dtype)
        np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
        n_el = n_close = 0
        cpu_leaves = dict(param_leaves(pc))
        for path, leaf in param_leaves(pg):
            want = cpu_leaves[path]
            if leaf.grad is not None:
                g, gw = leaf.grad.cpu().numpy(), want.grad.numpy()
                d = np.abs(g - gw)
                if dtype == torch.float64:
                    assert (d <= 1e-6 + 1e-4 * np.abs(gw)).all(), path
                else:
                    assert d.max() <= 1e-6 + 1e-4 * np.abs(gw).max(), path
                dp = np.abs(leaf.detach().cpu().numpy() - want.detach().numpy())
                assert dp.max() <= 2e-3, path
                n_el += dp.size
                n_close += int((dp <= 1e-5).sum())
            else:                                # moving statistics
                np.testing.assert_allclose(leaf.cpu().numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-6, err_msg=str(path))
        assert n_close >= 0.99 * n_el
        for key in BN_KEYS:
            for m in ("mean", "var"):
                np.testing.assert_allclose(sg[key][m].cpu().numpy(), sc[key][m].numpy(),
                                           rtol=1e-5, atol=1e-5)


def test_train_step_never_waits_for_the_device():
    """The upload of a batch from pinned memory and a whole train step
    (dropout on) only queue work on the card."""
    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.loop import _uploader
    from nanoreviser_torch.train.step import keras_adam, make_train_step, params_to_torch

    dev = _card()
    p, batch = _train_case(6, b=64)
    params = params_to_torch(p, dev)
    opt = keras_adam(params, 1e-3)
    step = make_train_step(ReviserConfig(window=13, n_classes=6))
    gen = torch.Generator(device=dev).manual_seed(0)
    up = _uploader(dev)
    step(params, opt, up(batch), gen)            # allocates Adam's state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics, _ = step(params, opt, up(batch), gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"]))


def _stacks(counts, b=128, t=13, seed=3):
    """numpy stacks [c, b, t, ...] of batches with 7 pad rows each."""
    rng = np.random.default_rng(seed)
    out = []
    for c in counts:
        w = np.ones((c, b), np.float32)
        w[:, -7:] = 0.0
        out.append({"signal": rng.normal(0, 1, (c, b, t, 50)).astype(np.float32),
                    "feats": rng.normal(0.5, 0.3, (c, b, t, 6)).astype(np.float32),
                    "y": rng.integers(-1, 6, (c, b)), "weight": w})
    return out


@pytest.mark.filterwarnings("ignore:.*capturable=True")
def test_graph_replays_match_eager_steps():
    """One warm-up call (eager), two replays of a 4-step graph and two of a
    1-step graph, against 14 eager steps with the same capturable Adam,
    from the same params and generator seed, dropout on, TF32 off, at
    T = 13, batch 128. Each step's loss within rtol 1e-5 and accuracy
    within 1e-6; after each call every param within 2e-3 and >= 99% of
    elements within 1e-5, the moving statistics within 1e-6 (the f32 bars
    of test_train_step_on_card_matches_cpu). Prints whether every step was
    bit-identical."""
    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.loop import _host_tensors
    from nanoreviser_torch.train.step import (
        GRAPHS, is_trained, keras_adam, make_multi_step, make_train_step,
        param_leaves, params_to_torch)

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, _ = _train_case(6)
    cfg = ReviserConfig(window=13, n_classes=6)
    assert cfg.dropout_rate > 0
    pe, pg = params_to_torch(p, dev), params_to_torch(p, dev)
    oe, og = keras_adam(pe, 1e-3, capturable=True), keras_adam(pg, 1e-3, capturable=True)
    ge = torch.Generator(device=dev).manual_seed(5)
    gg = torch.Generator(device=dev).manual_seed(5)
    step, multi = make_train_step(cfg), make_multi_step(cfg, device=dev)
    captures, replays = GRAPHS.captures, GRAPHS.replays
    identical = True
    for stack in _stacks([4, 4, 4, 1, 1]):
        got = multi(pg, og, _host_tensors(stack, pin=True), gg)
        want = []
        for i in range(len(stack["y"])):
            batch = _host_tensors({k: v[i] for k, v in stack.items()}, pin=False)
            want.append(step(pe, oe, {k: t.to(dev) for k, t in batch.items()}, ge)[0])
        for m, rtol in (("loss", 1e-5), ("accuracy", 0.0)):
            w = torch.stack([x[m] for x in want]).cpu().numpy()
            g = got[m].cpu().numpy()
            identical &= bool(np.array_equal(g, w))
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0 if rtol else 1e-6)
        n_el = n_close = 0
        for (path, a), (_, b) in zip(param_leaves(pg), param_leaves(pe)):
            a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
            identical &= bool(np.array_equal(a, b))
            d = np.abs(a - b)
            if not is_trained(path):
                assert (d <= 1e-6 + 1e-6 * np.abs(b)).all(), path
                continue
            assert d.max() <= 2e-3, path
            n_el += d.size
            n_close += int((d <= 1e-5).sum())
        assert n_close >= 0.99 * n_el
    assert (GRAPHS.captures - captures, GRAPHS.replays - replays) == (2, 4)
    print(f"graph replays bit-identical to eager steps: {identical}")


def _loop_data(n_windows, t, seed=0):
    rng = np.random.default_rng(seed)
    n = n_windows + t
    return (rng.normal(0.5, 0.3, (n, 6)).astype(np.float32),
            rng.normal(0, 1, (n, 50)).astype(np.float32),
            rng.integers(0, 6, (n_windows, 1)).astype(np.int32))


def test_resume_graphed_checkpoint_on_cpu_and_back(tmp_path):
    """300 windows at T = 13, batch 32: 9 steps an epoch (graphs of 4 and
    1). Epoch 1 graphed on the card, epoch 2 resumed on the CPU, epoch 3
    resumed on the card; Adam's step counter carries on across them."""
    from nanoreviser_torch.train.loop import load_checkpoint, train_model
    from nanoreviser_torch.train.step import GRAPHS

    _card()
    ck = str(tmp_path / "ck.pt")
    kw = dict(n_classes=6, window=13, batch_size=32, validation_split=0.1, seed=2,
              verbose=False, checkpoint_path=ck, steps_per_dispatch=4)
    data = _loop_data(300, 13)
    replays = GRAPHS.replays
    for epochs, device, capturable in ((1, "cuda", True), (2, "cpu", False),
                                       (3, "cuda", True)):
        _, hist = train_model(*data, epochs=epochs, device=device,
                              resume=epochs > 1, **kw)
        assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"]).all()
        saved = load_checkpoint(ck)
        assert saved["epoch"] == epochs
        assert all(g["capturable"] == capturable
                   for g in saved["opt_state"]["param_groups"])
        assert all(float(s["step"]) == 9 * epochs
                   for s in saved["opt_state"]["state"].values())
    assert GRAPHS.replays - replays == 2 * 2    # per card epoch: one 4, one 1


@pytest.mark.filterwarnings("ignore:.*capturable=True")
def test_graphed_steps_never_wait_for_the_device():
    """After the warm-up and the capture, a call (pinned stack up, replay,
    metrics copied out) only queues work on the card."""
    from nanoreviser_torch.models import ReviserConfig
    from nanoreviser_torch.train.loop import _host_tensors
    from nanoreviser_torch.train.step import keras_adam, make_multi_step, params_to_torch

    dev = _card()
    p, _ = _train_case(6, b=64)
    params = params_to_torch(p, dev)
    opt = keras_adam(params, 1e-3, capturable=True)
    multi = make_multi_step(ReviserConfig(window=13, n_classes=6), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = _stacks([2], b=64)[0]
    for _ in range(2):                            # warm-up, then the capture
        multi(params, opt, _host_tensors(stack, pin=True), gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = multi(params, opt, _host_tensors(stack, pin=True), gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(metrics["loss"].cpu().numpy()).all()


def test_torch_dp_on_card_matches_native():
    from nanoreviser_torch.align import sw

    dev = _card()
    rng = np.random.default_rng(5)
    for k in range(3):
        ref = "".join(rng.choice(list("ACGT"), 1500))
        read = "".join(c if rng.random() > 0.08 else "ACGT"[rng.integers(4)]
                       for c in ref[100 + k : 1400 - k] if rng.random() > 0.03)
        for band in (128, 512):
            got = sw.align_banded(read, ref, band=band, t_lead=100, t_tail=100,
                                  backend="torch", device=dev)
            want = sw.align_banded(read, ref, band=band, t_lead=100, t_tail=100,
                                   backend="native")
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    got = sw.align_banded("G", "ACGTTGCA" * 40, band=16, backend="torch", device=dev)
    assert got[1:] == sw.align_banded("G", "ACGTTGCA" * 40, band=16)[1:]
