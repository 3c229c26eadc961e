"""The harness: a cell, a mix, a configuration and a metric added by files
and entries alone; each metric's arithmetic on a recorded run; the last
line; no result without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, yardstick

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _copy_checkout(dst):
    shutil.copytree(os.path.join(ROOT, "portbench"), dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")


def test_every_cell_resolves():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    for w in bench["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        assert cell.entry().run
        assert cell.limits["logit_gap"]["limit"] > 0
        names = [m["name"] for m in cell.metrics("end_to_end")]
        assert "setup_s" in names and len(names) >= 2
        for m in cell.metrics("end_to_end") + cell.metrics("per_layer"):
            assert cell.reader(m["name"]).UNIT == m["unit"]
        assert cell.metrics("per_layer")


def test_cell_added_by_new_files_only(tmp_path):
    """A new configuration, mix, metric and cell: new files and new entries
    in BENCHMARK.json, no file that exists edited."""
    _copy_checkout(tmp_path)
    pb = tmp_path / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "nanoreviser-t11.json").read_text())
    cfg.update(name="nanoreviser-t12", window=12)
    (pb / "configs" / "nanoreviser-t12.json").write_text(json.dumps(cfg))
    trf = json.loads((pb / "traffic" / "revise-genomic.json").read_text())
    trf["lengths"]["median"] = 400
    (pb / "traffic" / "revise-short.json").write_text(json.dumps(trf))
    (pb / "limits" / "t12-revise-short.json").write_text(
        json.dumps({"logit_gap": {"limit": 0.25}}))
    (pb / "metrics" / "passes.count.py").write_text(
        "UNIT = 'passes'\n\ndef read(rec):\n    return len(rec['passes'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "nanoreviser-t12", "source": "x",
                             "file": "portbench/configs/nanoreviser-t12.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "t12-revise-short", "config": "nanoreviser-t12",
                               "traffic": "revise-short", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "revised_bases_per_s":
            m["workloads"].append("t12-revise-short")
    bench["per_layer"].append({"name": "passes.count", "unit": "passes",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "revised_bases_per_s",
                               "workloads": ["t12-revise-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell(str(tmp_path), "t12-revise-short")
    assert cell.config["window"] == 12 and cell.traffic["lengths"]["median"] == 400
    assert cell.limits["logit_gap"]["limit"] == 0.25
    assert cell.traffic["entry"] == "revise"
    layer = [m["name"] for m in cell.metrics("per_layer")]
    assert "passes.count" in layer
    assert cell.reader("passes.count").read({"passes": [1, 2]}) == 2
    old = harness.Cell(str(tmp_path), "t11-revise-genomic")
    assert "passes.count" not in [m["name"] for m in old.metrics("per_layer")]
    assert before == {p: p.read_bytes() for p in before}


def recorded(trace: bool) -> dict:
    """A run's record as the revise entry returns it (numbers made up)."""
    cfg = harness.Cell(ROOT, "t11-revise-genomic").config
    p = {"seconds": 9.0, "rc": 0, "bases": 33_000_000, "windows": 32_956_000,
         "rows": 32_996_000}
    if trace:
        p.update(span_s={"prep_wait": 1.5, "add_read": 2.0, "submit": 0.5,
                         "merge": 1.0, "write": 0.5, "device_wait": 0.2},
                 pool_start_s=[1.2], engines=[{"batches": 170, "windows": 32_640_000,
                                               "reads": 4000}])
    rec = {"config": cfg, "setup_s": 14.0, "window_s": 27.0, "passes": [p] * 3,
           "attempted": 12000, "failed": 0,
           "checks": {"missing": {"value": 0, "limit": 0},
                      "logit_gap": {"value": 0.05, "limit": 0.3}},
           "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                      "count": 1, "memory_peak_bytes": 3_000_000_000},
           "trace": None}
    if trace:
        rec["trace"] = {"busy_s": 13.5, "window_s": 27.0,
                        "ops": {"void stack_full_kernel<2>(FullPair, ...)": 12.0,
                                "window_gather_kernel": 0.01},
                        "launches": {"void stack_full_kernel<2>(FullPair, ...)": 510,
                                     "window_gather_kernel": 510},
                        "idle": {"prep_wait": 5.0, "other": 8.5}}
        rec["device"].update(busy_s=13.5, window_s=27.0)
        rec["breakdown"] = {"device_ops": [["stack_full", 12.0]],
                            "idle_gaps": [["other", 8.5]]}
    return rec


def test_metric_arithmetic():
    cell = harness.Cell(ROOT, "t11-revise-genomic")
    e2e = harness.metric_values(cell, "end_to_end", recorded(False))
    assert e2e["revised_bases_per_s"]["value"] == pytest.approx(99e6 / 27.0)
    assert e2e["setup_s"]["value"] == 14.0
    layer = harness.metric_values(cell, "per_layer", recorded(True))
    v = {k: m["value"] for k, m in layer.items()}
    assert v["hostpipe.start_s"] == pytest.approx(1.2)
    assert v["hostpipe.wait_share"] == pytest.approx(100 * 4.5 / 27.0)
    assert v["streaming.host_ms_per_batch"] == pytest.approx(1e3 * 3 * 4.0 / 510)
    assert v["streaming.windows_per_batch"] == pytest.approx(32_640_000 / 170)
    assert v["device.idle_share.revise"] == pytest.approx(50.0)
    flops = yardstick.model_flops(cell.config, 3 * 32_956_000, 3 * 32_996_000)
    assert v["mfu.revise"] == pytest.approx(100 * flops / 27.0 / 989e12)
    assert v["stack_full_roofline"] == pytest.approx(100 * flops / 989e12 / 12.0)
    assert 0 < v["stack_full_roofline"] < 100
    # an untraced record has nothing per layer but what the clock gives
    bare = harness.metric_values(cell, "per_layer", recorded(False))
    assert set(bare) == {"mfu.revise"}


def test_result_line():
    cell = harness.Cell(ROOT, "t11-revise-genomic")
    line = harness.result_line(cell, recorded(True), trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "breakdown", "checks"]
    assert line["correct"] is True
    assert {"busy_s", "window_s", "platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    json.dumps(line)
    rec = recorded(False)
    rec["checks"]["logit_gap"]["value"] = 0.5
    line = harness.result_line(cell, rec, trace=False)
    assert line["correct"] is False and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"revised_bases_per_s", "setup_s"}


def test_no_result_without_a_card(tmp_path):
    """On a machine with no card the run fails at once and prints no
    result: it does not fall back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "t11-revise-genomic", "--seed", str(2 ** 33),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone has no program to
    run: it exits non-zero with no result."""
    _copy_checkout(tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "t11-revise-genomic", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "nanoreviser_tpu_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nanoreviser_tpu.ops", object())
    assert harness.forbidden_modules() == ["nanoreviser_tpu"]
