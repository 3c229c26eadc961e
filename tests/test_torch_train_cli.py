"""The port's labelling and training command line vs the JAX package (CPU).

* ``label_read`` (the banded SW engine) on synthetic fast5 reads against a
  mutated genome, one read on each strand: the ``.npz`` cache holds arrays
  equal to the JAX package's, dtypes included; the GraphMap engine, driven
  by a stub executable as tests/test_graphmap_oracle.py drives it, too.
* ``python -m nanoreviser_torch.cli.train --test_mode --device cpu`` runs
  end to end (pseudo-genome, labels, 2 epochs, export) in a scratch cwd.
* A CPU run writes every artifact: both packages' ``load_keras_weights``
  read the ``.h5``, which holds the ``.npz`` weights, and the history CSV
  and parameters JSON are byte-equal to the JAX writer's output for the
  same history and summary.
* Without ``--device cpu`` the CLI raises on a host with no card, before
  a multi-process run joins its group.
* Two CLI processes (``--num_processes 2``, gloo on localhost) label
  disjoint shards into a cache equal to one process's, write each
  artifact once (process 0), suffix their failed-read files ``.rank<k>``,
  and train weights within the loop test's bar of one process's.
"""

import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from nanoreviser_torch.io.synthetic import write_synthetic_dir
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

STUB = f"""#!{sys.executable}
import os, sys
opts = dict(zip(sys.argv[2::2], sys.argv[3::2]))
seq = open(opts["-d"]).read().splitlines()[1]
with open(opts["-o"], "w") as fp:
    fp.write("@SQ\\tSN:chr\\tLN:1000000\\n")
    fp.write("r\\t0\\tchr\\t1\\t60\\t" + str(len(seq)) + "M\\t*\\t0\\t0\\t" + seq + "\\t*\\n")
"""


def _mutate(rng, seq, sub=0.02, ins=0.004, dele=0.004):
    out = []
    for ch in seq:
        r = rng.random()
        if r < dele:
            continue
        out.append("ACGT"[rng.integers(4)] if r < dele + sub else ch)
        if rng.random() < ins:
            out.append("ACGT"[rng.integers(4)])
    return "".join(out)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Three synthetic reads and a genome of their mutated bases (the
    second read's reverse complement)."""
    from nanoreviser_torch.align.sam import rev_comp
    from nanoreviser_torch.io import get_read_data

    d = tmp_path_factory.mktemp("train_cli")
    fast5 = d / "fast5"
    names = write_synthetic_dir(str(fast5), 3, (500, 700), seed=4)
    rng = np.random.default_rng(4)
    chroms = []
    for k, n in enumerate(names):
        bases = get_read_data(str(fast5 / n)).bases
        g = _mutate(rng, bases)
        chroms.append(rev_comp(g) if k == 1 else g)
    genome = d / "genome.fasta"
    genome.write_text("".join(f">chr{k} test\n{g}\n" for k, g in enumerate(chroms)))
    return d, fast5, names, genome


def _npz_equal(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_label_read_npz_equals_jax(reads, tmp_path):
    from nanoreviser_torch.align.sw import KmerIndex
    from nanoreviser_torch.io import parse_fasta
    from nanoreviser_torch.train.data import label_read, save_read_npz
    from nanoreviser_tpu.align.sw import KmerIndex as JaxIndex
    from nanoreviser_tpu.io import parse_fasta as jax_parse
    from nanoreviser_tpu.train.data import label_read as jax_label
    from nanoreviser_tpu.train.data import save_read_npz as jax_save

    _, fast5, names, genome_fn = reads
    genome = parse_fasta(genome_fn)
    assert genome == jax_parse(genome_fn) and sorted(genome) == ["chr0", "chr1", "chr2"]
    pidx, jidx = KmerIndex(genome), JaxIndex(genome)
    for n in names:
        got = label_read(str(fast5 / n), genome, kmer_index=pidx)
        want = jax_label(str(fast5 / n), genome, kmer_index=jidx)
        save_read_npz(got, str(tmp_path / f"port_{n}"))
        jax_save(want, str(tmp_path / f"jax_{n}"))
        _npz_equal(tmp_path / f"port_{n}.npz", tmp_path / f"jax_{n}.npz")
        # mutations show up as labels other than the read's own bases
        assert (got.mapvals != "M").sum() > 0


def test_graphmap_engine_equals_jax(reads, tmp_path):
    from nanoreviser_torch.train.data import label_read
    from nanoreviser_tpu.train.data import label_read as jax_label

    _, fast5, names, _ = reads
    exe = tmp_path / "graphmap"
    exe.write_text(STUB)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    from nanoreviser_torch.io import get_read_data

    fn = str(fast5 / names[0])
    genome_fn = tmp_path / "self.fasta"
    genome_fn.write_text(">chr\n" + get_read_data(fn).bases + "\n")
    genome = {"chr": get_read_data(fn).bases}
    kw = dict(engine="graphmap", genome_fn=str(genome_fn), graphmap_exe=str(exe))
    got = label_read(fn, genome, tmp_dir=str(tmp_path / "p"), **kw)
    want = jax_label(fn, genome, tmp_dir=str(tmp_path / "j"), **kw)
    for f in ("refvals", "refvals2", "readvals", "signal_x", "mapvals", "starts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.scale, got.shift) == (want.scale, want.shift)
    assert set(got.mapvals) == {"M"} and os.listdir(tmp_path / "p") == []


def test_test_mode_end_to_end(reads, tmp_path, monkeypatch):
    from nanoreviser_torch.cli.train import main

    _, fast5, _, _ = reads
    monkeypatch.chdir(tmp_path)
    assert main(["-d", str(fast5), "--test_mode", "--device", "cpu"]) == 0
    log = (tmp_path / "unitest" / "unitest_log.txt").read_text()
    assert "Congratulations, NanoReviser_train is installed properly" in log
    # test mode removes what it wrote
    assert not (tmp_path / "model" / "unitest").exists()
    assert not (tmp_path / "train_tmp").exists()


def test_cli_artifacts_read_by_both_packages(reads, tmp_path, monkeypatch):
    import nanoreviser_torch.utils.files as port_files
    from nanoreviser_torch.cli.train import main
    from nanoreviser_torch.models import load_keras_weights
    from nanoreviser_torch.train.loop import load_params_npz
    from nanoreviser_tpu.models import load_keras_weights as jax_load
    from nanoreviser_tpu.utils.files import write_summary_file as jax_write

    _, fast5, names, genome = reads
    written = []
    write = port_files.write_summary_file

    def recording(history, summary, history_fn, summary_fn):
        written.append((history, summary, history_fn, summary_fn))
        return write(history, summary, history_fn, summary_fn)

    monkeypatch.setattr(port_files, "write_summary_file", recording)
    out, model = tmp_path / "out", tmp_path / "model"
    rc = main(["-d", str(fast5), "-r", str(genome), "-o", str(out), "-M", str(model),
               "-t", str(tmp_path / "tmp"), "-S", "syn", "-e", "2", "-w", "5",
               "-b", "128", "--thread", "2", "--device", "cpu",
               "-f", str(tmp_path / "failed.txt")])
    assert rc == 0 and not (tmp_path / "failed.txt").exists()
    species = model / "syn"
    assert sorted(os.listdir(species / "training_input")) == [
        n.split(".")[0] + ".npz" for n in names]
    for tag, n_classes in (("model1", 6), ("model2", 5)):
        stem = f"syn_win5_2ep_{tag}"
        npz = load_params_npz(str(species / f"{stem}.npz"))
        assert (species / "training_model" / f"train_{stem}.npz").exists()
        assert npz["centers"].shape == (n_classes, 16)
        for loader in (load_keras_weights, jax_load):
            params, window, nc = loader(str(species / f"{stem}.h5"))
            assert (window, nc) == (5, n_classes)
            for k in ("conv1", "dense1", "final_out"):
                np.testing.assert_array_equal(np.asarray(params[k]["w"]), npz[k]["w"])
            np.testing.assert_array_equal(params["total_rnn2"]["bwd"]["wh"],
                                          npz["total_rnn2"]["bwd"]["wh"])
            np.testing.assert_array_equal(params["bn_t1"]["var"], npz["bn_t1"]["var"])
        hist = (out / f"{stem}_hisroty.csv").read_text().splitlines()
        assert hist[0] == "loss,accuracy,val_loss,val_accuracy" and len(hist) == 3
        assert all(np.isfinite(float(v)) for v in hist[1].split(","))
    assert len(written) == 2
    for history, summary, history_fn, summary_fn in written:
        assert summary["epochs"] == 2 and summary["species"] == "syn"
        jh, js = str(tmp_path / "jax.csv"), str(tmp_path / "jax.json")
        jax_write(history, summary, jh, js)
        assert open(history_fn, "rb").read() == open(jh, "rb").read()
        assert open(summary_fn, "rb").read() == open(js, "rb").read()
        assert json.loads(open(summary_fn).read()) == summary
    # the CSV writer on awkward values: NaN (no validation windows), tiny,
    # huge and integral floats
    history = {"loss": [0.1 + 0.2, 1e-05], "accuracy": [1.0, 2.5e-300],
               "val_loss": [float("nan")] * 2, "val_accuracy": [1e16, 1 / 3]}
    write(history, {"a": 1}, str(tmp_path / "p.csv"), str(tmp_path / "p.json"))
    jax_write(history, {"a": 1}, str(tmp_path / "j.csv"), str(tmp_path / "j.json"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_cli_transfer_learning_and_resume(reads, tmp_path, monkeypatch):
    """--model1_train_dir starts model1 from an .h5 (the reference parses
    the flag and ignores it); --resume reaches train_model."""
    import nanoreviser_torch.train.loop as loop
    from nanoreviser_torch.cli.train import main
    from nanoreviser_torch.models import (
        ReviserConfig, init_reviser_params, load_keras_weights, save_keras_weights)

    _, fast5, _, genome = reads
    start = str(tmp_path / "start.h5")
    save_keras_weights(init_reviser_params(torch.Generator().manual_seed(9),
                                           ReviserConfig(window=5, n_classes=6)),
                       start, 5, 6)
    calls = []

    def fake_train(x, sig, y, **kw):
        calls.append(kw)
        p = dict(kw["init_params"], centers=np.zeros((6, 16), np.float32))
        return p, {"loss": [1.0], "accuracy": [0.5], "val_loss": [1.0],
                   "val_accuracy": [0.5]}

    monkeypatch.setattr(loop, "train_model", fake_train)
    rc = main(["-d", str(fast5), "-r", str(genome), "-o", str(tmp_path / "o"),
               "-M", str(tmp_path / "m"), "-t", str(tmp_path / "t"), "-e", "1",
               "-w", "5", "--model_type", "model1", "--model1_train_dir", start,
               "--resume", "--device", "cpu", "-f", str(tmp_path / "failed.txt")])
    assert rc == 0 and len(calls) == 1
    kw = calls[0]
    assert kw["resume"] and kw["n_classes"] == 6 and kw["window"] == 5
    assert kw["checkpoint_path"].endswith("model1_checkpoint.pt")
    want, _, _ = load_keras_weights(start)
    np.testing.assert_array_equal(kw["init_params"]["dense1"]["w"], want["dense1"]["w"])


def test_cli_needs_a_card_unless_cpu(reads, tmp_path, monkeypatch):
    from nanoreviser_torch.cli.train import main

    _, fast5, _, genome = reads
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-d", str(fast5), "-r", str(genome)])
    # a multi-process run checks for the card before it joins the group
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-d", str(fast5), "-r", str(genome), "--num_processes", "2",
              "--coordinator_address", "localhost:1", "--process_id", "0"])
    assert os.listdir(tmp_path) == []        # nothing ran


# runs the training CLI with its artifact writers logging (process, path)
WRITE_LOGGER = """
import os, sys
import nanoreviser_torch.models as models
import nanoreviser_torch.train.loop as loop
import nanoreviser_torch.utils.files as files
rank = sys.argv[sys.argv.index("--process_id") + 1]

def logged(fn, *positions):
    def write(*args, **kwargs):
        with open(os.environ["WRITE_LOG"], "a") as fp:
            for i in positions:
                fp.write(rank + "\\t" + str(args[i]) + "\\n")
        return fn(*args, **kwargs)
    return write

models.save_keras_weights = logged(models.save_keras_weights, 1)
loop.save_params_npz = logged(loop.save_params_npz, 1)
loop.save_checkpoint = logged(loop.save_checkpoint, 0)
files.write_summary_file = logged(files.write_summary_file, 2, 3)
from nanoreviser_torch.cli.train import main
sys.exit(main(sys.argv[1:]))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cli_equals_one_process(reads, tmp_path):
    import subprocess

    from nanoreviser_torch.cli.train import main
    from nanoreviser_torch.train.loop import load_params_npz

    _, fast5, names, genome = reads
    src = tmp_path / "fast5"          # the reads and two broken files, one per shard
    src.mkdir()
    for n in names:
        os.symlink(fast5 / n, src / n)
    for bad in ("a_bad.fast5", "z_bad.fast5"):
        (src / bad).write_bytes(b"not an hdf5 file")
    flags = ["-d", str(src), "-r", str(genome), "-S", "syn", "-e", "1", "-w", "5",
             "-b", "256", "--thread", "1", "--device", "cpu"]

    def run_flags(tag):
        return flags + ["-o", str(tmp_path / tag / "out"), "-M", str(tmp_path / tag / "m"),
                        "-t", str(tmp_path / tag / "tmp"),
                        "-f", str(tmp_path / tag / "failed.txt")]

    coord = f"127.0.0.1:{_free_port()}"
    log = tmp_path / "writes.log"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WRITE_LOG=str(log), PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WRITE_LOGGER, *run_flags("two"),
         "--coordinator_address", coord, "--num_processes", "2", "--process_id", str(k)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(2)]
    try:
        assert main(run_flags("one")) == 0
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    one, two = tmp_path / "one", tmp_path / "two"
    # failed reads: one file per process, each naming its shard's broken read
    assert (one / "failed.txt").read_text().split("\n")[0].startswith("a_bad.fast5\t")
    assert not (two / "failed.txt").exists()
    for k, bad in enumerate(("a_bad.fast5", "z_bad.fast5")):
        lines = (two / f"failed.txt.rank{k}").read_text().splitlines()
        assert [ln.split("\t")[0] for ln in lines] == [bad]
    # the label cache: the union of the shards, equal to one process's
    caches = sorted(os.listdir(one / "m" / "syn" / "training_input"))
    assert caches == [n.split(".")[0] + ".npz" for n in names]
    assert sorted(os.listdir(two / "m" / "syn" / "training_input")) == caches
    for c in caches:
        _npz_equal(one / "m" / "syn" / "training_input" / c,
                   two / "m" / "syn" / "training_input" / c)
    # every artifact written once, by process 0
    writes = [ln.split("\t") for ln in log.read_text().splitlines()]
    paths = [w[1] for w in writes]
    assert {w[0] for w in writes} == {"0"} and len(paths) == len(set(paths)) == 12
    for tag, n_classes in (("model1", 6), ("model2", 5)):
        stem = f"syn_win5_1ep_{tag}"
        want = [two / "m" / "syn" / f"{stem}.npz", two / "m" / "syn" / f"{stem}.h5",
                two / "m" / "syn" / "training_model" / f"train_{stem}.npz",
                two / "m" / "syn" / "training_model" / f"{tag}_checkpoint.pt",
                two / "out" / f"{stem}_hisroty.csv", two / "out" / f"{stem}_parameters.json"]
        for path in want:
            assert str(path) in paths and path.exists(), path
        # trained weights and history within the loop test's bars (its
        # params bar: a few Adam steps' worth; f32 rounding alone moves
        # near-zero gradients' updates by up to lr a step, while in f64 two
        # processes equal one to 1e-12, tests/test_torch_dp.py)
        a = load_params_npz(str(one / "m" / "syn" / f"{stem}.npz"))
        b = load_params_npz(str(two / "m" / "syn" / f"{stem}.npz"))
        assert [p for p, _ in _leaves(a)] == [p for p, _ in _leaves(b)]
        for k in ("dense1", "final_out"):
            assert np.abs(b[k]["w"] - a[k]["w"]).max() < 1e-3
        ha = (one / "out" / f"{stem}_hisroty.csv").read_text().splitlines()[1].split(",")
        hb = (two / "out" / f"{stem}_hisroty.csv").read_text().splitlines()[1].split(",")
        for col in (0, 2):                               # loss, val_loss
            np.testing.assert_allclose(float(hb[col]), float(ha[col]), rtol=1e-3)
        assert a["final_out"]["b"].shape == (n_classes,)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])
