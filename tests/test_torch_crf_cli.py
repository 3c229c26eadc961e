"""The reviser CLI's ``--revise_mode basecaller --basecaller_model`` on the
CPU: synthetic fast5 files through ``cli.reviser.main``, the prep pool's
signal job and ``infer.basecall``, against the plain reference
``torch_crf_reference`` (features 16, state_len 2, chunks of 400 samples,
the weights of ``test_torch_crf_decode``). The files written hold exactly
the reference's reads (fasta) and reads and qualities (fastq); the traced
run records the engine's spans and counters.
"""

import json
import os

import numpy as np
import pytest

import torch_crf_reference as ref
from nanoreviser_torch.cli.reviser import main as cli_main
from nanoreviser_torch.io import hdf5
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.models import crf
from test_torch_crf_decode import CFG, model, ref_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("crf_cli")
    fast5 = root / "fast5"
    names = write_synthetic_dir(str(fast5), 4, (30, 400), seed=19)
    m = model(0)
    crf.save_bonito_model(m, str(root / "model"))
    sigs = []
    for name in names:
        with hdf5.File(str(fast5 / name), "r") as f:
            reads = f["/Raw/Reads/"]
            sigs.append(np.asarray(reads[reads.keys()[0] + "/Signal"][()]))
    want = ref.basecall_reads(crf.export_bonito_state(m), ref_cfg(CFG), sigs,
                              quality=True)
    return root, names, sigs, want


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_cli_writes_the_reference_reads(setup, tmp_path, fmt):
    root, names, sigs, want = setup
    out, failed, tr = tmp_path / "out", tmp_path / "failed.txt", tmp_path / "t.json"
    rc = cli_main(["-d", str(root / "fast5"), "-o", str(out), "-F", fmt,
                   "--revise_mode", "basecaller", "--basecaller_model",
                   str(root / "model"), "--device", "cpu", "--thread", "2",
                   "-e", str(failed), "--trace_json", str(tr)])
    assert rc == 0 and not failed.exists()
    for name, (seq, qual) in zip(names, want):
        text = (out / (name.split(".")[0] + f"_out.{fmt}")).read_text()
        assert seq
        if fmt == "fasta":
            assert text == f">{name}\n{seq}"
        else:
            assert text == f"@{name}\n{seq}+\n{qual}"
    got = json.loads(tr.read_text())
    for span in ("basecall.chunk", "basecall.submit", "basecall.lstm",
                 "basecall.fetch_wait", "basecall.stitch", "cli.engine_init"):
        assert got["span_calls"].get(span, 0) >= 1, span
    counters = got["counters"]
    assert counters["basecall.samples"] == sum(len(s) for s in sigs)
    assert counters["basecall.chunks"] >= len(names)
    assert counters["basecall.batches"] >= 1 and counters["pool.worker_s"] > 0
    assert counters["pool.worker_reads"] == len(names)


def test_cli_reports_an_unreadable_file(setup, tmp_path):
    root, names, _, want = setup
    src = tmp_path / "in"
    src.mkdir()
    for name in names[:2]:
        os.link(root / "fast5" / name, src / name)
    (src / "broken.fast5").write_bytes(b"not an hdf5 file")
    out, failed = tmp_path / "out", tmp_path / "failed.txt"
    rc = cli_main(["-d", str(src), "-o", str(out), "--revise_mode", "basecaller",
                   "--basecaller_model", str(root / "model"), "--device", "cpu",
                   "--thread", "1", "-e", str(failed)])
    assert rc == 1
    assert failed.read_text().startswith("broken.fast5\t")
    assert sorted(os.listdir(out)) == sorted(n.split(".")[0] + "_out.fasta"
                                             for n in names[:2])
    assert (out / (names[1].split(".")[0] + "_out.fasta")).read_text() == (
        f">{names[1]}\n{want[1][0]}")
