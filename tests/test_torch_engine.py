"""Port engine and CLI vs the JAX package (CPU), and the port's import and
device rules.

* Engine labels (``emit="labels"``, ``device="cpu"``: the plain f32 path)
  equal the JAX ``use_pallas=False`` engine's, except on windows whose f32
  top-2 logit margin is below 1e-4 (both sides are f32; only summation order
  differs). With qualities on, the merged sequences are identical and the
  phred qualities differ by at most one on at most 0.1% of bases.
* The port CLI's passthrough fasta and fastq are byte-identical to the JAX
  CLI's; model mode writes one file per read.
* Importing every port module pulls in neither jax nor nanoreviser_tpu.
* Without CUDA the engine's default device raises instead of falling back,
  and a device-step fault propagates instead of degrading reads.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nanoreviser_tpu.infer import StreamingReviser as JaxReviser
from nanoreviser_tpu.io import get_read_data as jax_get_read_data
from nanoreviser_torch.infer import StreamingReviser
from nanoreviser_torch.infer.wire import decode_wire, encode_read, wire_to_tensors
from nanoreviser_torch.io import get_read_data
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.models import ReviserConfig, init_reviser_params, save_keras_weights
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.ops.reviser_kernel import stack_logits_plain
from nanoreviser_torch.ops.window_gather import window_gather_plain
from nanoreviser_torch.signal import compact_read_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

BATCH, BLOCK = 2048, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine")
    fast5 = str(d / "fast5")
    names = write_synthetic_dir(fast5, 5, (150, 380), seed=21)
    paths = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(100 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=11, n_classes=nc)), gen)
        paths.append(str(d / f"m{k + 1}.h5"))
        save_keras_weights(p, paths[-1], 11, nc)
    return d, fast5, names, paths


def _port_logits(eng, reads):
    """The f32 logits the CPU engine computes for one batch of ``reads``."""
    packed, tier, n = eng.pack_batch(
        [(name, encode_read(compact_read_numpy(rd))) for name, rd in reads])
    assert n == len(reads)
    d = decode_wire(wire_to_tensors(packed), s_cap=tier.s_cap,
                    n_rows=tier.n_rows, n_rows_g=tier.n_rows_g)
    wv, nv = int(packed["wvalid"][0]), int(packed["nv"][0])
    win = window_gather_plain(d.sig, d.pos0, d.vlen, d.read_id, d.shift,
                              d.scale, nv * 128, out_dtype=torch.float32, width=50)
    logits, _ = stack_logits_plain(eng._ws, win, d.feats, t_len=eng.window,
                                   w_valid=wv, n_windows=tier.w_max,
                                   want_probs=False, bf16=False)
    return logits.numpy()


def test_engine_labels_match_jax_engine(setup):
    _, fast5, names, paths = setup
    reads = [(n, get_read_data(os.path.join(fast5, n))) for n in names]
    eng = StreamingReviser(*paths, batch_windows=BATCH, block=BLOCK, device="cpu")
    errors = []
    got = {n: (y1, y2) for n, _, y1, y2 in
           eng.revise_stream(reads, errors=errors, emit="labels")}
    assert not errors
    je = JaxReviser(*paths, batch_windows=BATCH, block=BLOCK, use_pallas=False,
                    devices=jax.devices()[:1])
    jreads = [(n, jax_get_read_data(os.path.join(fast5, n))) for n in names]
    want = {n: (y1, y2) for n, _, y1, y2 in je.revise_stream(jreads, emit="labels")}

    logits = _port_logits(eng, reads)
    r0, n_windows, n_near = 0, 0, 0
    for name, rd in reads:
        wr = rd.n_bases - eng.window
        for m in range(2):
            a, b = got[name][m], want[name][m]
            assert len(a) == len(b) == wr
            top2 = np.sort(logits[m, r0 : r0 + wr, : eng.n_classes[m]], axis=1)[:, -2:]
            near = (top2[:, 1] - top2[:, 0]) < 1e-4
            assert (a[~near] == b[~near]).all(), (name, m)
            n_near += int(near.sum())
        n_windows += wr
        r0 += rd.n_bases
    assert n_windows > 1000 and n_near < 0.01 * n_windows
    # labels are not degenerate
    assert len(np.unique(np.concatenate([got[n][0] for n in names]))) > 1


def test_engine_sequences_and_qualities_match_jax_engine(setup):
    """Merged sequences are identical; phred qualities (uint8 casts of
    log10 in two frameworks) may differ by one on at most 0.1% of bases."""
    _, fast5, names, paths = setup
    reads = [(n, get_read_data(os.path.join(fast5, n))) for n in names]
    eng = StreamingReviser(*paths, batch_windows=BATCH, block=BLOCK,
                           emit_quality=True, device="cpu")
    errors = []
    got = {n: (s, q) for n, _, s, q in eng.revise_stream(reads, errors=errors)}
    assert not errors
    je = JaxReviser(*paths, batch_windows=BATCH, block=BLOCK, use_pallas=False,
                    emit_quality=True, devices=jax.devices()[:1])
    jreads = [(n, jax_get_read_data(os.path.join(fast5, n))) for n in names]
    want = {n: (s, q) for n, _, s, q in je.revise_stream(jreads)}
    n_bases, n_off = 0, 0
    for n in names:
        (seq, qual), (jseq, jqual) = got[n], want[n]
        assert seq == jseq, n
        a = np.frombuffer(qual.encode(), np.uint8).astype(np.int32)
        b = np.frombuffer(jqual.encode(), np.uint8).astype(np.int32)
        assert len(a) == len(seq) and np.abs(a - b).max() <= 1, n
        n_bases += len(a)
        n_off += int((a != b).sum())
    assert n_bases > 1000 and n_off <= 0.001 * n_bases


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_cli_passthrough_byte_identical_to_jax(setup, fmt):
    from nanoreviser_tpu.cli.reviser import main as jax_main
    from nanoreviser_torch.cli.reviser import main as port_main

    d, fast5, names, _ = setup
    outs = {}
    for tag, main in (("port", port_main), ("jax", jax_main)):
        out = d / f"pass_{tag}_{fmt}"
        rc = main(["-d", fast5, "-o", str(out), "-F", fmt, "--revise_mode",
                   "passthrough", "-e", str(d / f"failed_{tag}.txt")])
        assert rc == 0
        outs[tag] = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
    assert len(outs["port"]) == len(names)
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_cli_model_mode_writes_one_file_per_read(setup, fmt):
    from nanoreviser_torch.cli.reviser import main

    d, fast5, names, paths = setup
    out = d / f"model_{fmt}"
    failed = d / f"model_failed_{fmt}.txt"
    rc = main(["-d", fast5, "-o", str(out), "-F", fmt, "--revise_mode", "model",
               "--device", "cpu",
               "--model1_predict_dir", paths[0], "--model2_predict_dir", paths[1],
               "-e", str(failed)])
    assert rc == 0 and not failed.exists()
    files = sorted(os.listdir(out))
    assert files == [n.split(".")[0] + f"_out.{fmt}" for n in names]
    for f in files:
        text = (out / f).read_text()
        header, body = text.split("\n", 1)
        assert header[1:] == names[files.index(f)]
        if fmt == "fastq":
            seq, qual = body.split("+\n")
            assert len(seq) == len(qual)
            assert all(33 <= ord(c) <= 33 + 93 for c in qual)
        else:
            assert set(body) <= set("ACGTN")


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys, nanoreviser_torch\n"
        "for m in pkgutil.walk_packages(nanoreviser_torch.__path__, 'nanoreviser_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('nanoreviser_tpu') or m == 'h5py']\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('nanoreviser_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_default_device_requires_cuda(setup, monkeypatch):
    _, _, _, paths = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingReviser(*paths)


def test_bad_reads_degrade_but_device_faults_raise(setup, monkeypatch):
    import dataclasses

    _, fast5, names, paths = setup
    rd = get_read_data(os.path.join(fast5, names[0]))
    bad = dataclasses.replace(rd, starts=rd.starts[:1], bases=rd.bases[:1])
    eng = StreamingReviser(*paths, batch_windows=BATCH, block=BLOCK, device="cpu")
    errors = []
    out = list(eng.revise_stream([("bad", bad), ("ok", rd)], errors=errors))
    assert [o[0] for o in out] == ["bad", "ok"]
    assert out[0][2] == bad.bases and [e[0] for e in errors] == ["bad"]

    def fault(*a, **k):
        raise RuntimeError("simulated device fault")

    monkeypatch.setattr(eng, "_device_step", fault)
    with pytest.raises(RuntimeError, match="simulated device fault"):
        list(eng.revise_stream([("ok", rd)], errors=errors))
