"""The in-process basecaller (``models.crf``, ``ops.crf_decode``,
``infer.basecall``) against the plain reference ``torch_crf_reference``, on
the CPU at small widths (features 16, state_len 2, chunks of 400 samples),
on seeded random weights; the decode kernel on the card (marker ``cuda``).

Weights: PyTorch's initialisation from the seed, the convolutions' and
LSTMs' scaled by 3, the linear layer's weights by 8 and its bias lowered by
1, so
that the scores use tanh's range and the decode emits bases (at PyTorch's
bounds alone every step is a stay).

Tolerances: the encoder's scores agree within 1e-5 (float32 on both sides;
torch's LSTM and the reference's step-by-step products sum the same terms
in other orders, ~1e-7 relative); posteriors within 1e-5 absolute (the
same sums in float32 over 80 steps); labels, reads and qualities exactly
(the decodes take the same float32 steps, so they agree unless two paths
tie within rounding, which these seeds do not).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_crf_reference as ref
from nanoreviser_torch.infer import basecall
from nanoreviser_torch.models import crf
from nanoreviser_torch.ops import crf_decode as dec
from nanoreviser_torch.signal.host_prep import SignalRead, signal_normalizers
from nanoreviser_torch.utils import trace
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

CFG = crf.CrfConfig(features=16, state_len=2, chunksize=400, overlap=60)


def ref_cfg(cfg):
    return {k: getattr(cfg, k) for k in (
        "features", "n_layers", "stride", "winlen", "state_len", "scale",
        "blank_score", "chunksize", "overlap")}


def model(seed, cfg=CFG):
    torch.manual_seed(seed)
    m = crf.CrfEncoder(cfg).eval()
    with torch.no_grad():
        for p in list(m.convs.parameters()) + list(m.rnns.parameters()):
            p.mul_(3.0)
        m.linear.weight.mul_(8.0)
        m.linear.bias.sub_(1.0)
    return m


def signals(seed, lengths):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        levels = np.repeat(rng.integers(400, 500, n // 9 + 1), 9)[:n]
        out.append(np.rint(levels + rng.normal(0, 5, n)).astype(np.int16))
    return out


def engine_reads(model_dir, sigs, quality, batch_chunks=4, device="cpu"):
    eng = basecall.Basecaller(model_dir, device=device, emit_quality=quality,
                              batch_chunks=batch_chunks)
    items = []
    for k, s in enumerate(sigs):
        shift, scale = signal_normalizers(s)
        items.append((f"r{k}", SignalRead(s, shift, scale)))
    errors = []
    got = [(seq, qual) for _, seq, qual in eng.basecall_stream(items, errors)]
    return got, errors, eng


def test_encoder_scores_match_reference():
    m = model(0)
    x = torch.from_numpy(np.stack([ref.normalise(s) for s in signals(1, [400] * 3)]))
    with torch.no_grad():
        got = m(x[:, None, :])
        want = ref.scores(ref.Ops(), crf.export_bonito_state(m), ref_cfg(CFG), x)
    assert got.shape == (80, 3, 64)
    np.testing.assert_allclose(got.reshape(80, 3, 16, 4).numpy(),
                               want[..., 1:].numpy(), atol=1e-5)
    assert (want[..., 0] == CFG.blank_score).all()


def test_posteriors_and_labels_match_reference():
    m = model(1)
    x = torch.from_numpy(np.stack([ref.normalise(s) for s in signals(2, [400] * 4)]))
    with torch.no_grad():
        sc = m(x[:, None, :])
        want_post = ref.posteriors(ref.scores(ref.Ops(), crf.export_bonito_state(m),
                                              ref_cfg(CFG), x), CFG.state_len)
        got_post = dec.crf_posteriors_plain(sc, CFG.blank_score, CFG.state_len)
        np.testing.assert_allclose(got_post.numpy(), want_post.numpy(), atol=1e-5)
        np.testing.assert_allclose(got_post.sum((2, 3)).numpy(), 1.0, atol=1e-5)
        labels, quals = dec.crf_decode_plain(sc, CFG.blank_score, CFG.state_len,
                                             quality=True)
        want_labels, want_quals = ref.chunk_labels(
            ref.Ops(), crf.export_bonito_state(m), ref_cfg(CFG), x, True)
    assert (labels.numpy() == want_labels).all()
    assert (quals.numpy() == want_quals).all()
    assert 0 < (want_labels != 0).mean() < 1


@pytest.mark.parametrize("lengths", [
    [300],                    # one chunk, padded on the left
    [400],                    # one chunk, exactly
    [500, 740],               # two chunks: a stub, and none
    [2000, 6666, 399, 8642],  # many chunks, across batches of 4 and 7
])
@pytest.mark.parametrize("batch_chunks", [4, 7])
def test_stitch_and_trim_match_reference(tmp_path, lengths, batch_chunks):
    m = model(2)
    crf.save_bonito_model(m, str(tmp_path / "m"))
    sigs = signals(3, lengths)
    want = ref.basecall_reads(crf.export_bonito_state(m), ref_cfg(CFG), sigs,
                              quality=True)
    was = trace.enable(True)
    trace.take()
    try:
        got, errors, _ = engine_reads(str(tmp_path / "m"), sigs, True, batch_chunks)
        counters = trace.take()["counters"]
    finally:
        trace.enable(was)
    assert got == want
    assert errors == [] and all(s for s, _ in got)
    chunks = sum(len(basecall.chunk_starts(n, 400, 60)[0]) for n in lengths)
    assert counters["basecall.chunks"] == chunks
    assert counters["basecall.batches"] == -(-chunks // batch_chunks)
    assert counters["basecall.samples"] == sum(lengths)


def test_keep_ranges_cover_each_sample_once():
    for n in (300, 400, 401, 740, 741, 1080, 2000, 6666):
        starts, pad, stub = basecall.chunk_starts(n, 400, 60)
        keep = basecall.keep_ranges(len(starts), stub, 80, 400, 60, 5)
        steps = sum(hi - lo for lo, hi in keep)
        assert steps == (80 if n <= 400 else n // 5), (n, keep)
        assert starts[-1] + 400 == max(n, 400) and pad == max(400 - n, 0)


def test_bonito_state_import_round_trip(tmp_path):
    m = model(3)
    crf.save_bonito_model(m, str(tmp_path / "m"), n=2)
    torch.save({"x": torch.zeros(1)}, tmp_path / "m" / "weights_1.tar")
    back = crf.load_bonito_model(str(tmp_path / "m"))    # the highest n
    assert back.cfg == CFG
    for k, v in m.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    state = crf.export_bonito_state(m)
    assert sorted(state)[:2] == ["encoder.0.conv.bias", "encoder.0.conv.weight"]
    assert "encoder.8.rnn.weight_hh_l0" in state and "encoder.9.linear.bias" in state
    wrapped = {"module." + k: v for k, v in state.items()}
    assert all(torch.equal(a, b) for a, b in zip(
        crf.import_bonito_state(wrapped, CFG).values(),
        crf.import_bonito_state(state, CFG).values()))
    del state["encoder.9.linear.bias"]
    with pytest.raises(ValueError, match="encoder.9.linear.bias"):
        crf.import_bonito_state(state, CFG)


@pytest.mark.parametrize("mutation", ["reverse", "move_index"])
def test_changed_rules_fail_the_comparison(tmp_path, monkeypatch, mutation):
    m = model(6)
    crf.save_bonito_model(m, str(tmp_path / "m"))
    sigs = signals(5, [2000, 1280])
    want = ref.basecall_reads(crf.export_bonito_state(m), ref_cfg(CFG), sigs)
    assert all(seq for seq, _ in want)
    assert engine_reads(str(tmp_path / "m"), sigs, False)[0] == want
    if mutation == "reverse":
        monkeypatch.setattr(crf.CrfConfig, "reverse",
                            lambda self, i: (self.n_layers - i) % 2 == 0)
    else:
        real = dec.tables

        def shifted(state_len, device=None):
            prev, succ_s, succ_j = real(state_len, device)
            hi = 4 ** state_len // 4
            s = torch.arange(4 ** state_len, device=device)
            prev = torch.stack([s] + [(s % hi) * 4 + r for r in range(4)], 1)
            return prev, succ_s, succ_j
        monkeypatch.setattr(dec, "tables", shifted)
    assert engine_reads(str(tmp_path / "m"), sigs, False)[0] != want


def _toml(doc: dict) -> str:
    out = []
    for table, items in doc.items():
        out.append(f"[{table}]")
        for k, v in items.items():
            out.append(f"{k} = " + (f'"{v}"' if isinstance(v, str) else
                                    repr(v).replace("'", '"')))
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("section, key, value", [
    ("global_norm", "state_len", 6),
    ("encoder", "rnn_type", "gru"),
    ("encoder", "activation", "relu"),
    ("model", "package", "bonito.ctc"),
])
def test_unsupported_config_is_refused(tmp_path, section, key, value):
    import tomllib

    crf.save_bonito_model(model(5), str(tmp_path / "m"))
    path = tmp_path / "m" / "config.toml"
    doc = tomllib.loads(path.read_text())
    doc[section][key] = value
    path.write_text(_toml(doc))
    with pytest.raises(ValueError, match=f"{section}.{key} = {value!r}"):
        basecall.Basecaller(str(tmp_path / "m"), device="cpu")


def test_empty_read_degrades(tmp_path):
    crf.save_bonito_model(model(6), str(tmp_path / "m"))
    eng = basecall.Basecaller(str(tmp_path / "m"), device="cpu")
    sig = signals(7, [1200])[0]
    items = [("a", SignalRead(np.zeros(0, np.int16), 0.0, 1.0)),
             ("b", SignalRead(sig, *signal_normalizers(sig))),
             ("c", SignalRead(sig[:20], *signal_normalizers(sig[:20])))]
    errors = []
    got = list(eng.basecall_stream(items, errors))
    assert [n for n, _, _ in got] == ["a", "b", "c"]
    # a read shorter than a chunk is decoded over its padding too
    assert got[0][1] is None and got[1][1] and got[2][1]
    assert errors == [("a", "read has no signal")]


# --------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("state_len", [2, 4])
def test_decode_kernel_matches_plain(state_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(state_len)
    n_states = 4 ** state_len
    for t_len, n in ((40, 3), (160, 17)):
        sc = (torch.tanh(torch.randn(t_len, n, 4 * n_states, generator=g) * 2 - 0.5)
              * 5.0).half()
        want = dec.crf_decode_plain(sc.float().cuda(), 2.0, state_len, True)
        got = dec.crf_decode(sc.cuda(), 2.0, state_len, True)
        agree = (got[0] == want[0]).float().mean().item()
        assert agree >= 0.999, agree
        moved = (got[0] != 0) & (got[0] == want[0])
        assert (got[1][moved].int() - want[1][moved].int()).abs().max() <= 1
        again = dec.crf_decode(sc.cuda(), 2.0, state_len, True)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.cuda
def test_engine_on_card_matches_reference(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(CFG, state_len=4, features=64)
    m = model(8, cfg)
    crf.save_bonito_model(m, str(tmp_path / "m"))
    sigs = signals(9, [2000, 6666, 300])
    want = ref.basecall_reads(crf.export_bonito_state(m), ref_cfg(cfg), sigs,
                              device="cuda", quality=True)
    got, _, _ = engine_reads(str(tmp_path / "m"), sigs, True, 8, "cuda")
    for (s, q), (ws, wq) in zip(got, want):
        assert s is not None and abs(len(s) - len(ws)) <= 0.05 * len(ws)
