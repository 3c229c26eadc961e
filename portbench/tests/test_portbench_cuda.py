"""On a card: a whole run of a tiny revision cell through the program's
CUDA kernels, judged against the reference, and the trace's reduction.
Skips without a card (run on one: python -m pytest
portbench/tests/test_portbench_cuda.py)."""

import time

import pytest

from portbench import harness

from test_portbench_faults import cell  # noqa: F401  (the tiny checkout)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, cell, trace):  # noqa: F811
    rec = cell.entry().run(cell, seed=2 ** 34 + 5, seconds=1.0, trace=trace,
                           device="cuda", t0=time.perf_counter())
    line = harness.result_line(cell, rec, trace=trace)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        tl = rec["trace"]
        assert 0 < tl["busy_s"] <= tl["window_s"]
        assert any("stack_full" in k for k in tl["ops"])
        assert 0 < line["metrics"]["stack_full_roofline"]["value"] < 100
        assert line["breakdown"]["device_ops"]
    else:
        assert line["metrics"]["revised_bases_per_s"]["value"] > 0
