"""The basecaller's LSTM layer (``ops.lstm``): its packing, its plain
version against ``nn.LSTM`` on the CPU, the engine's route by width, and on
the card (marker ``cuda``; this file imports no JAX, so it runs there with
``--noconftest``) the kernel ``csrc/lstm_layer.cu`` against the plain
version and the engine's kernel route against cuDNN.

Tolerances on the CPU: the plain version and ``nn.LSTM`` both run f32 and
sum the same products in other orders (~1e-7 relative a step), so they
agree within 1e-5 over 50 steps; the reversed layer and flip -> layer ->
flip take the same steps in the same order, so they agree exactly.
"""

import numpy as np
import pytest
import torch
from torch import nn

from nanoreviser_torch.infer import basecall
from nanoreviser_torch.models import crf
from nanoreviser_torch.ops import lstm
from nanoreviser_torch.signal.host_prep import SignalRead, signal_normalizers
from nanoreviser_torch.utils import trace
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

LSTM_GAIN = 3.0     # the models' LSTM weights: PyTorch's bounds x 3


def seeded_lstm(h: int, seed: int) -> nn.LSTM:
    torch.manual_seed(seed)
    rnn = nn.LSTM(h, h)
    with torch.no_grad():
        for w in rnn.parameters():
            w.mul_(LSTM_GAIN)
    return rnn.eval()


def seeded_inputs(t_len: int, n: int, h: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(t_len, n, h, generator=g) * 2 - 1


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_nn_lstm(reverse):
    rnn = seeded_lstm(64, 1)
    x = seeded_inputs(50, 8, 64, 2)
    p = lstm.pack_lstm(rnn)
    got = lstm.lstm_layer(x, p, reverse)          # the CPU takes the plain version
    with torch.no_grad():
        want = rnn(x.flip(0))[0].flip(0) if reverse else rnn(x)[0]
    assert torch.allclose(got, want, rtol=0, atol=1e-5), (got - want).abs().max()
    if reverse:
        flipped = lstm.lstm_layer_plain(x.flip(0), p, False).flip(0)
        assert torch.equal(got, flipped)


def test_gate_order_is_a_permutation():
    h = 64
    order = lstm.gate_order(h)
    assert torch.equal(order.sort().values, torch.arange(4 * h))
    rnn = seeded_lstm(h, 3)
    p = lstm.pack_lstm(rnn)
    for u, g in ((0, 0), (5, 1), (17, 2), (63, 3)):
        assert torch.equal(p.w_ih[4 * u + g], rnn.weight_ih_l0[g * h + u])
        assert torch.equal(p.w_hh[4 * u + g], rnn.weight_hh_l0[g * h + u])
        assert p.bias[4 * u + g] == rnn.bias_ih_l0[g * h + u] + rnn.bias_hh_l0[g * h + u]


def test_hh_fragments_round_trip():
    """The register images hold every element of W_hh once: scattered back
    by the same index they give W_hh again."""
    h = lstm.KERNEL_FEATURES
    rows, cols = lstm._fragment_index(h)
    flat = (rows * h + cols).reshape(-1)
    assert torch.equal(flat.sort().values, torch.arange(4 * h * h))
    g = torch.Generator().manual_seed(4)
    w = torch.randn(4 * h, h, generator=g).half()
    frag = lstm.hh_fragments(w)
    assert frag.dtype == torch.int32 and frag.shape == (8, 3, 4, h // 16, 32, 4)
    back = torch.empty_like(w)
    back[rows, cols] = frag.view(torch.float16).view(rows.shape)
    assert torch.equal(back, w)
    # lane 5 (q 1, p 1) of CTA 2, warpgroup 1, warp 3, k tile 7: register 1
    # holds row q + 8 (gate f of unit 48 * 2 + 16 + 12 + 1) at columns
    # 16 * 7 + 2, + 3
    pair = frag[2, 1, 3, 7, 5, 1].reshape(1).view(torch.float16)
    unit = 48 * 2 + 16 * 1 + 4 * 3 + 1
    assert torch.equal(pair, w[4 * unit + 1, 16 * 7 + 2 : 16 * 7 + 4])


def test_projection_takes_the_stems_layout():
    """The stem's output is a [T, N, H] view of [N, H, T]: its projection is
    a view of [N, T, 4H] with contiguous rows (no transposing copy of x),
    equal to the projection of the same x made contiguous, and the layer
    over it equals the layer over the contiguous x."""
    rnn = seeded_lstm(16, 8)
    p = lstm.pack_lstm(rnn)
    x = seeded_inputs(7, 3, 16, 9)
    x = x.permute(1, 2, 0).contiguous().permute(2, 0, 1)  # [T, N, H] view of [N, H, T]
    xp = lstm.input_projection(x, p)
    assert xp.shape == (7, 3, 64) and xp.stride() == (64, 7 * 64, 1)
    assert torch.allclose(xp, lstm.input_projection(x.contiguous(), p), atol=1e-6)
    for reverse in (False, True):
        assert torch.allclose(lstm.lstm_layer(x, p, reverse),
                              lstm.lstm_layer(x.contiguous(), p, reverse), atol=1e-6)


@pytest.mark.parametrize("features,device,route", [
    (384, "cuda", "kernel"), (768, "cuda", "cudnn"), (64, "cuda", "cudnn"),
    (384, "cpu", "torch"), (64, "cpu", "torch")])
def test_route_by_features(features, device, route):
    assert lstm.lstm_route(features, torch.device(device)) == route
    assert lstm.kernel_holds(features) == (features == 384)


def test_fragments_refuse_other_widths():
    with pytest.raises(ValueError, match="holds features 384"):
        lstm.hh_fragments(torch.zeros(4 * 64, 64, dtype=torch.float16))


SMALL = crf.CrfConfig(features=16, state_len=2, chunksize=400, overlap=60)


def small_model_dir(tmp_path, seed=5):
    torch.manual_seed(seed)
    m = crf.CrfEncoder(SMALL).eval()
    with torch.no_grad():
        for w in list(m.convs.parameters()) + list(m.rnns.parameters()):
            w.mul_(3.0)
        m.linear.weight.mul_(8.0)
        m.linear.bias.sub_(1.0)
    path = str(tmp_path / "m")
    crf.save_bonito_model(m, path)
    return path


def level_signals(seed, lengths):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        levels = np.repeat(rng.integers(400, 500, n // 9 + 1), 9)[:n]
        out.append(np.rint(levels + rng.normal(0, 5, n)).astype(np.int16))
    return out


def run_engine(model_dir, sigs):
    eng = basecall.Basecaller(model_dir, device="cpu", emit_quality=True,
                              batch_chunks=4)
    items = [(f"r{k}", SignalRead(s, *signal_normalizers(s)))
             for k, s in enumerate(sigs)]
    was = trace.enable(True)
    trace.take()
    try:
        got = [(seq, qual) for _, seq, qual in eng.basecall_stream(items, [])]
    finally:
        took = trace.take()
        trace.enable(was)
    return eng, got, took["counters"]


def test_engine_kernel_route_matches_nn_lstm(tmp_path, monkeypatch):
    """The engine's kernel route (the packed layers, each layer's direction
    an argument, no flips) gives the reads of its nn.LSTM route; on the CPU
    the kernel route runs the plain version. The counter counts the layers
    a batch ran on that route."""
    model_dir = small_model_dir(tmp_path)
    sigs = level_signals(6, [2000, 5000, 300])
    eng, want, counters = run_engine(model_dir, sigs)
    assert eng.lstm_route == "torch" and not eng._packed
    assert counters["basecall.lstm_kernel_layers"] == 0
    monkeypatch.setattr(lstm, "lstm_route", lambda features, device: "kernel")
    eng, got, counters = run_engine(model_dir, sigs)
    assert len(eng._packed) == SMALL.n_layers
    assert got == want
    assert all(s for s, _ in got)
    assert (counters["basecall.lstm_kernel_layers"]
            == SMALL.n_layers * counters["basecall.batches"])


# --------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain_hac(reverse):
    """One layer at the HAC widths on one full batch (1,024 chunks x 800
    steps): the kernel against the plain version on the card, from the same
    input projection (the same torch.matmul). Both round h to fp16 each
    step; they differ only in the order of the f32 sums of the recurrent
    product and in the kernel's MUFU nonlinearities against torch's sigmoid
    and tanh (~1e-6 relative), so an h_t differs where those tip its fp16
    rounding: by one fp16 ulp (2^-11 at 0.5 <= |h| < 1). The recurrence
    carries such a step into later ones damped, so about a fifth of the
    elements end one ulp apart and none further (measured on an H100: max
    2^-11, mean 1.07e-5; cuDNN against the same plain version: max 2^-10,
    mean 2.9e-5). Bars: every element within 2^-9 (4 ulps), the mean
    within 2^-14 (6x the measured), and two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rnn = seeded_lstm(384, 7).cuda().half()
    x = seeded_inputs(800, 1024, 384, 8).cuda().half()
    p = lstm.pack_lstm(rnn)
    got = lstm.lstm_layer(x, p, reverse)
    want = lstm.lstm_layer_plain(x, p, reverse)
    again = lstm.lstm_layer(x, p, reverse)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    assert torch.equal(again, got)
    assert diff.max().item() <= 2 ** -9, diff.max().item()
    assert diff.mean().item() <= 2 ** -14, diff.mean().item()


@pytest.mark.cuda
def test_kernel_takes_partial_clusters():
    """Chunk counts that leave the last cluster part-filled, short
    sequences, and the stem's permuted layout (the projection read through
    its strides): the kernel against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rnn = seeded_lstm(384, 9).cuda().half()
    p = lstm.pack_lstm(rnn)
    for t_len, n, permuted in ((1, 1, False), (37, 70, False), (5, 200, False),
                               (37, 70, True)):
        x = seeded_inputs(t_len, n, 384, t_len).cuda().half()
        if permuted:        # the stem's layout: a [T, N, H] view of [N, H, T]
            x = x.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        for reverse in (False, True):
            got = lstm.lstm_layer(x, p, reverse)
            want = lstm.lstm_layer_plain(x, p, reverse)
            torch.cuda.synchronize()
            assert (got.float() - want.float()).abs().max().item() <= 2 ** -9


def hac_engine(tmp_path, batch_chunks):
    torch.manual_seed(11)
    m = crf.CrfEncoder(crf.CrfConfig()).eval()
    with torch.no_grad():
        for w in list(m.convs.parameters()) + list(m.rnns.parameters()):
            w.mul_(3.0)
        m.linear.weight.mul_(8.0)
        m.linear.bias.mul_(8.0).add_(-1.0)
    crf.save_bonito_model(m, str(tmp_path / "hac"))
    return basecall.Basecaller(str(tmp_path / "hac"), device="cuda",
                               batch_chunks=batch_chunks)


@pytest.mark.cuda
def test_engine_kernel_labels_against_cudnn(tmp_path):
    """One full batch of chunks from seeded reads through the engine's
    kernel route and its cuDNN route (the same fp16 weights), and through
    the same model in f32 (TF32 off): the shares of chunks and of labels
    that differ. With random weights the decode has near-ties, so any
    change of rounding moves some label in most chunks of 800 steps (cuDNN
    against itself moved 4 of 1,024 chunks); the bar is that the kernel's
    labels are no further from the f32 model's than cuDNN's are (within
    1.5x, or 0.1 % of labels). Also the captured replay equals the eager
    kernel route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from nanoreviser_torch.ops import crf_decode as dec

    eng = hac_engine(tmp_path, 1024)
    assert eng.lstm_route == "kernel" and len(eng._packed) == 5
    c = eng.cfg.chunksize
    sigs = level_signals(12, [c * 8] * 128)
    rows, meta = [], []
    for s in sigs:
        shift, scale = signal_normalizers(s)
        for k in range(8):
            rows.append(s[k * c : (k + 1) * c])
            meta.append((shift, scale, 0.0))
    sig = torch.from_numpy(np.stack(rows)).cuda()
    meta = torch.tensor(meta, dtype=torch.float32).t().contiguous().cuda()
    kernel = eng._device_step(sig, meta)[0]
    slot = eng._acquire()
    slot.host_sig.copy_(sig.cpu())
    slot.host_meta.copy_(meta.cpu())
    eng._submit(slot)
    replay = eng._fetch(slot)[0]
    packed, eng._packed = eng._packed, []
    cudnn = eng._device_step(sig, meta)[0]
    eng._packed = packed
    m32 = copy.deepcopy(eng.model).float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            x = (sig.float() - meta[0][:, None]) / meta[1][:, None]
            scores = m32.head(m32.lstms(m32.stem(x[:, None, :])))
            f32 = dec.crf_decode(scores.half().contiguous(), eng.cfg.blank_score,
                                 eng.cfg.state_len)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.synchronize()
    assert np.array_equal(replay, kernel.cpu().numpy())
    chunks = (kernel != cudnn).any(1).float().mean().item()
    k_f32 = (kernel != f32).float().mean().item()
    c_f32 = (cudnn != f32).float().mean().item()
    print(f"chunks whose labels differ, kernel against cuDNN: {chunks:.4f}; labels "
          f"differing from the f32 model: kernel {k_f32:.5f}, cuDNN {c_f32:.5f}")
    assert k_f32 <= max(1.5 * c_f32, 0.001), (k_f32, c_f32)


@pytest.mark.cuda
def test_replay_launches_the_kernel_per_layer(tmp_path):
    """The engine's captured replays launch the LSTM kernel once per layer
    and batch (and per eager warm-up batch), the counter agrees, and no
    cuDNN RNN kernel runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType

    eng = hac_engine(tmp_path, 16)
    sigs = level_signals(13, [40000, 90000, 30000])
    items = [(f"r{k}", SignalRead(s, *signal_normalizers(s)))
             for k, s in enumerate(sigs)]
    was = trace.enable(True)
    trace.take()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            got = list(eng.basecall_stream(items, []))
            torch.cuda.synchronize()
    finally:
        counters = trace.take()["counters"]
        trace.enable(was)
    assert all(seq for _, seq, _ in got)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    batches = counters["basecall.batches"]
    assert batches >= 2
    assert sum("lstm_layer_kernel" in nm for nm in names) == 5 * batches
    assert counters["basecall.lstm_kernel_layers"] == 5 * batches
    assert not [nm for nm in names if "rnn" in nm.lower()]
