"""The benchmark's inputs read back by the program's own readers, equal to
the arrays the benchmark wrote; the traffic's fixed sizes."""

import os

import numpy as np
import pytest
import torch

from portbench.inputs import reads, weights
from portbench.reference import reviser as ref

CFG = {"window": 11, "signal_len": 50, "n_features": 6, "conv_filters": 8,
       "conv_kernel": 3, "signal_dense_units": 64, "lstm_units": [16, 64, 128, 64],
       "dense_units": [128, 32], "main_out_units": 6, "feature_units": 16,
       "n_classes": [6, 5]}


def test_fast5_reads_back(tmp_path):
    from nanoreviser_torch.io import extract_fastq, get_read_data

    names, rs = reads.make_reads(str(tmp_path), [700, 1500, 3000], seed=2 ** 40 + 7)
    for name, r in zip(names, rs):
        path = os.path.join(tmp_path, name)
        got = get_read_data(path)
        assert got.bases == r.bases
        assert np.array_equal(got.signal, r.signal)
        bases, st, dur, ab_mean, ab_std, tail = ref.decode(r.events, r.signal)
        assert bases.tobytes().decode() == got.bases
        assert np.array_equal(st, got.starts)
        assert np.array_equal(dur, got.lengths)
        assert np.array_equal(np.float32(ab_mean), got.ab_mean)
        assert np.array_equal(np.float32(ab_std), got.ab_std)
        assert np.array_equal(tail, got.signal[got.read_start_rel_to_raw:])
        fq, qual = extract_fastq(path)
        assert fq == r.bases and len(qual) == len(fq)
        assert {"N", "A", "C", "G", "T"} >= set(r.bases)


def test_native_ingest_reads_them(tmp_path):
    """The program's one-call ingest (its C++ HDF5 reader) takes the files."""
    from nanoreviser_torch.signal.host_prep import compact_fast5, compact_read
    from nanoreviser_torch.io import get_read_data

    names, _ = reads.make_reads(str(tmp_path), [900, 2500], seed=5)
    for name in names:
        path = os.path.join(tmp_path, name)
        a = compact_fast5(path)
        b = compact_read(get_read_data(path))
        assert np.array_equal(a.csig, b.csig) and np.array_equal(a.feats, b.feats)


@pytest.mark.parametrize("window", [11, 13])
def test_keras_weights_read_back(tmp_path, window):
    from nanoreviser_torch.models import load_keras_weights

    cfg = dict(CFG, window=window)
    for nc in (6, 5):
        p = weights.random_params(cfg, nc, seed=3, device="cpu")
        path = str(tmp_path / f"m{nc}.h5")
        weights.save_keras_weights(p, path)
        got, w, n = load_keras_weights(path)
        assert (w, n) == (window, nc)

        def walk(a, b):
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k])
                else:
                    assert np.array_equal(np.asarray(b[k]), a[k]), k
        walk(p, got)


def test_weights_from_seed():
    a = weights.random_params(CFG, 6, seed=9, device="cpu")
    b = weights.random_params(CFG, 6, seed=9, device="cpu")
    c = weights.random_params(CFG, 6, seed=10, device="cpu")
    assert np.array_equal(a["total_rnn1"]["fwd"]["wh"], b["total_rnn1"]["fwd"]["wh"])
    assert not np.array_equal(a["total_rnn1"]["fwd"]["wh"], c["total_rnn1"]["fwd"]["wh"])
    assert a["final_out"]["w"].shape == (16, 6)
    assert a["feature"]["w"].shape == (66, 16)
    assert torch.tensor(a["read_rnn1"]["fwd"]["b"][16:32]).min() > 0.6   # forget


def test_label_shares():
    """The insert and delete classes win the share asked of them, whatever
    the logits' scale; the other classes keep their order."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((20000, 6)) * np.array([0.5, 3.0, 1, 1, 1, 1])
    logits[:, 0] += 4.0                       # class 0 would win nearly always
    p = {"final_out": {"b": np.zeros(6, np.float32)}}
    weights.set_label_shares(p, logits, {0: 0.05, 1: 0.05})
    won = np.bincount((logits + p["final_out"]["b"]).argmax(1), minlength=6)
    assert np.allclose(won[:2] / len(logits), 0.05, atol=0.003)
    assert np.all(p["final_out"]["b"][2:] == 0)


def test_lengths_fixed_and_lognormal():
    n = reads.lognormal_lengths(64, 6000, 0.8, 500, 60000)
    assert len(n) == 64 and np.all(np.diff(n) >= 0)
    assert abs(np.median(n) - 6000) < 300
    assert 7500 < n.mean() < 9000                 # log-normal mean 6000 e^0.32
    assert 0.7 < np.std(np.log(n)) < 0.8           # stratified: just under sigma
    c = reads.lognormal_lengths(64, 800, 0.5, 200, 3000)
    assert 200 <= c.min() and c.max() <= 3000 and 850 < c.mean() < 950


def test_links_and_copies(tmp_path):
    copies = reads.copies_per_read(4000, 64)
    assert sum(copies) == 4000 and set(copies) == {62, 63}
    target = tmp_path / "t.fast5"
    target.write_bytes(b"x")
    a = reads.link_dir(str(tmp_path / "a"), [str(target)] * 3, [2, 3, 5], seed=1)
    b = reads.link_dir(str(tmp_path / "b"), [str(target)] * 3, [2, 3, 5], seed=1)
    assert a == b and len(a) == 10
    assert sorted(np.bincount(list(a.values()))) == [2, 3, 5]
    assert all(os.path.isfile(tmp_path / "a" / n) for n in a)
