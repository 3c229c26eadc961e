"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped, the program's plain f32 path), sound and with the timed path
broken underneath: every fault a revision cell can have comes out as not
correct, and so does the control (the reference in float8 products in the
program's place)."""

import json
import shutil
import tempfile
import time

import pytest

from portbench import harness

from test_portbench_harness import ROOT, _copy_checkout

TINY = {"entry": "revise", "why": "tiny", "distinct_reads": 4, "reads_per_pass": 10,
        "lengths": {"median": 300, "sigma": 0.3, "min": 100, "max": 1000},
        "format": "fasta", "thread": 2}


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    _copy_checkout(root)
    (root / "portbench" / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    limit = harness.Cell(ROOT, "t11-revise-genomic").limits["logit_gap"]
    (root / "portbench" / "limits" / "t11-tiny.json").write_text(json.dumps(
        {"logit_gap": limit}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "t11-tiny", "config": "nanoreviser-t11",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "t11-revise-genomic" in m.get("workloads", []):
            m["workloads"].append("t11-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    yield harness.Cell(str(root), "t11-tiny")
    shutil.rmtree(root, ignore_errors=True)


def run(cell, seed=2 ** 35 + 3):
    rec = cell.entry().run(cell, seed=seed, seconds=0.0, trace=False,
                           device="cpu", t0=time.perf_counter())
    return harness.result_line(cell, rec, trace=False)


def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["logit_gap"]["value"] < 1e-3     # f32 against f32
    assert line["attempted"] == 10 and line["failed"] == 0
    assert line["metrics"]["revised_bases_per_s"]["value"] > 0


def test_answer_altered_where_it_is_produced(cell, monkeypatch):
    from nanoreviser_torch.infer.streaming import StreamingReviser

    step = StreamingReviser._device_step

    def altered(self, *args):
        labels, q = step(self, *args)
        labels = labels.clone()
        y1, y2 = labels[::53] >> 3, labels[::53] & 7
        labels[::53] = ((y1 + 3) % 6) * 8 + y2
        return labels, q

    monkeypatch.setattr(StreamingReviser, "_device_step", altered)
    line = run(cell)
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > line["checks"]["logit_gap"]["limit"]


def test_state_returned_unchanged(cell, monkeypatch):
    """The engine hands back each read as it came, unrevised."""
    from nanoreviser_torch.infer.streaming import StreamingReviser

    monkeypatch.setattr(StreamingReviser, "_merge_one",
                        lambda self, name, read, *a: (name, read, read.bases, None))
    line = run(cell)
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > line["checks"]["logit_gap"]["limit"]


def test_half_the_reads_left_out(cell, monkeypatch):
    import nanoreviser_torch.io as nio

    write = nio.write_read_fasta
    seen = []

    def half(fn, out, bases):
        seen.append(fn)
        if len(seen) % 2:
            write(fn, out, bases)

    monkeypatch.setattr(nio, "write_read_fasta", half)
    line = run(cell)
    assert line["correct"] is False
    assert line["checks"]["missing"]["value"] == 5 and line["failed"] == 5


def test_control_is_not_correct(cell):
    """The reference computed in float8 products, in the program's place,
    reads above the limit on every seed tried (reads of about 2,000 bases:
    the control's rounding has to flip a label where the merge shows it)."""
    entry = cell.entry()
    cell.traffic = dict(cell.traffic, lengths={"median": 2000, "sigma": 0.3,
                                               "min": 500, "max": 5000})
    limit = cell.limits["logit_gap"]["limit"]
    got = []
    for seed in (11, 12, 13):
        tmp = tempfile.mkdtemp()
        try:
            inputs = entry.setup(cell, seed, "cpu", tmp)
            rows, logits = entry.reference(cell, inputs, "cpu")
            got.append(entry.control_reading(cell, inputs, rows, logits,
                                             "cpu")["logit_gap"])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    cell.traffic = dict(TINY)
    assert min(got) > limit, got
