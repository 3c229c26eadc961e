"""The plain reference against the program's CPU path at tiny sizes, and the
reference's isolation from the program and from JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.inputs import reads, weights
from portbench.reference import reviser as ref

from test_portbench_inputs import CFG


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    names, rs = reads.make_reads(str(d), [400, 650], seed=2 ** 33 + 1)
    return d, names, rs


def test_rows_match_program_prep(tiny):
    from nanoreviser_torch.io import get_read_data
    from nanoreviser_torch.signal.host_prep import prep_read_numpy

    d, names, rs = tiny
    for name, r in zip(names, rs):
        bases, win, feats = ref.base_rows(r.events, r.signal)
        p = prep_read_numpy(get_read_data(os.path.join(d, name)))
        assert bases.tobytes().decode() == p.bases
        left = (50 - p.vlen.astype(int) + 1) // 2
        col = np.arange(50)[None, :]
        mask = (col >= left[:, None]) & (col < (left + p.vlen)[:, None])
        want = np.where(mask, (p.win - p.shift) / p.scale, 0.0)
        np.testing.assert_allclose(win, want, rtol=1e-6, atol=1e-6)
        # the program rounds its features to f16 once
        np.testing.assert_allclose(feats, p.feats.astype(np.float32), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("window", [11, 13])
def test_logits_match_program_model(tiny, window):
    from nanoreviser_torch.models import params_from_numpy, reviser_apply

    _, _, rs = tiny
    cfg = dict(CFG, window=window)
    rows = [ref.base_rows(r.events, r.signal) for r in rs]
    ps = [weights.random_params(cfg, nc, seed=21 + nc, device="cpu")
          for nc in (6, 5)]
    got = ref.read_logits(ps, rows, window, "cpu", block=97)
    for (bases, win, feats), per_model in zip(rows, got):
        n_win = len(bases) - window
        idx = np.arange(n_win)[:, None] + np.arange(window)[None, :]
        for p, lg in zip(ps, per_model):
            assert lg.shape == (n_win, p["final_out"]["b"].shape[0])
            probs, _ = reviser_apply(params_from_numpy(p), torch.tensor(win[idx]),
                                     torch.tensor(feats[idx]))
            np.testing.assert_allclose(torch.softmax(torch.tensor(lg), -1).numpy(),
                                       probs.numpy(), atol=2e-6)


@pytest.mark.parametrize("seed", [31, 41])
def test_labels_vary(seed):
    """The benchmark's weights give labels that vary from window to window
    and near ties, so the comparison is not of a constant."""
    r = reads.read_arrays(3000, np.random.default_rng(4))
    rows = [ref.base_rows(r.events, r.signal)]
    ps = [weights.random_params(CFG, nc, seed=seed + nc, device="cpu")
          for nc in (6, 5)]
    for lg in ref.read_logits(ps, rows, 11, "cpu")[0]:
        share = np.bincount(lg.argmax(1), minlength=lg.shape[1]) / len(lg)
        second = np.sort(lg.max(1, keepdims=True) - lg, 1)[:, 1]
        assert (share > 0.01).sum() >= 2 and np.mean(second < 0.1) > 0.01


def test_merge_and_offset_match_program():
    from nanoreviser_torch.infer.merge import calibrate_center_offset, merge_revision

    rng = np.random.default_rng(8)
    for n, t in ((300, 11), (90, 13), (20, 11)):
        bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n)
        y1 = rng.integers(0, 6, max(n - t, 0))
        y2 = rng.integers(0, 5, max(n - t, 0))
        text = bases.tobytes().decode()
        for off in (0, 5, t):
            want = merge_revision(text, y1, y2, align="center", window=t,
                                  center_offset=off)
            assert ref.merge(bases, y1, y2, off).decode() == want
        # a model that copies base i + 4: the offset is found
        chars = np.frombuffer(b"D-CTGA", np.uint8)
        y_copy = np.array([list(chars).index(b) if b in chars else 0
                           for b in bases[4 : 4 + len(y1)]], int)
        for y in (y1, y_copy):
            off, _ = ref.calibrate(bases, y, t)
            assert off == calibrate_center_offset(text, y, t)[0]


def test_control_differs_from_reference(tiny):
    _, _, rs = tiny
    rows = [ref.base_rows(r.events, r.signal) for r in rs]
    ps = [weights.random_params(CFG, nc, seed=41 + nc, device="cpu") for nc in (6, 5)]
    a = ref.read_logits(ps, rows, 11, "cpu")
    b = ref.read_logits(ps, rows, 11, "cpu", precision="fp8")
    d = max(float(np.abs(x - y).max()) for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    assert 0.01 < d < 5.0


def test_reference_imports_nothing_of_the_program():
    """The reference and the judge import neither JAX, nor the JAX package,
    nor the program (top-level module names compared whole)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import portbench.reference.reviser, portbench.judge, "
            "portbench.yardstick, portbench.inputs.reads, portbench.inputs.weights; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "nanoreviser_tpu", "nanoreviser_torch"}
