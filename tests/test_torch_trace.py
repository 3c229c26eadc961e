"""The port's tracer (``utils.trace``) and the spans and counters of the
CLI, the prep pool and the engine (CPU; one test marked ``cuda``).

* Off, a span is one shared no-op object and nothing is recorded; on,
  seconds and calls add up per name, a nested span counts in its parent
  too, counters add, and ``take`` starts anew. Spans are marked
  ``nanorev.<name>`` in a ``torch.profiler`` trace only while one runs.
* The CLI in model mode (``--device cpu``) with ``--trace_json``: every
  span of the CLI, pool and engine has calls, except the engine's two
  waits on the card (``engine.slot_wait``, ``engine.fetch_wait``), which
  the CPU engine has none of; ``engine.add_read`` counts at least one call
  a read, ``cli.write`` one a read written, ``pool.worker_reads`` every
  read prepped, with ``pool.worker_s`` > 0. The files written are
  byte-identical with tracing on and off, and the tracer is left as it was.
* No ``engine.*`` or ``pool.*`` span opens inside ``cli.emit``, and no span
  is open when a generator of the pool or the engine yields.
* On the card, a traced engine records both waits and marks its spans in
  the profiler's trace beside the device's kernels.
"""

import contextlib
import json
import os
import time

import pytest
import torch

from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.models import ReviserConfig, init_reviser_params, save_keras_weights
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.utils import trace
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

BAD = "read_0003_not_hdf5.fast5"
CLI_SPANS = ("cli.list", "cli.pool_spawn", "cli.engine_init", "cli.pool_ready",
             "cli.emit", "cli.write", "cli.pool_close", "cli.finish")
POOL_SPANS = ("pool.submit", "pool.wait", "pool.unpack")
ENGINE_SPANS = ("engine.add_read", "engine.new_batch", "engine.submit",
                "engine.unpack", "engine.calibrate", "engine.merge")
CARD_WAITS = ("engine.slot_wait", "engine.fetch_wait")


@pytest.fixture
def tracer():
    """The process's tracer, cleared, and put back as it was afterwards."""
    was = trace.enable(False)
    trace.take()
    yield trace
    trace.take()
    trace.enable(was)


def test_off_is_a_noop(tracer):
    a, b = trace.span("x"), trace.span("y")
    assert a is b
    with a:
        trace.count("c", 5)
    assert trace.take() == {"span_s": {}, "span_calls": {}, "counters": {}}


def test_on_adds_seconds_and_calls(tracer):
    assert trace.enable(True) is False
    for _ in range(3):
        with trace.span("outer"):
            time.sleep(0.002)
    got = trace.take()
    assert got["span_calls"] == {"outer": 3}
    assert got["span_s"]["outer"] >= 0.006


def test_nesting_is_inclusive(tracer):
    trace.enable(True)
    with trace.span("outer"):
        time.sleep(0.002)
        with trace.span("inner"):
            time.sleep(0.004)
    s = trace.take()["span_s"]
    assert s["inner"] >= 0.004
    assert s["outer"] >= s["inner"] + 0.002


def test_take_resets_and_counters_add(tracer):
    trace.enable(True)
    trace.count("reads")
    trace.count("reads", 2)
    trace.count("secs", 0.25)
    with trace.span("a"):
        pass
    got = trace.take()
    assert got["counters"] == {"reads": 3, "secs": 0.25}
    assert got["span_calls"] == {"a": 1}
    assert trace.take() == {"span_s": {}, "span_calls": {}, "counters": {}}
    assert trace.enable(False) is True


def test_profiler_marks_only_while_it_runs(tracer):
    trace.enable(True)
    with trace.span("bare") as s:
        assert s.mark is None
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("marked"):
            torch.ones(4).sum()
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert "nanorev.marked" in names and "nanorev.bare" not in names
    assert trace.take()["span_calls"] == {"bare": 1, "marked": 1}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    fast5 = str(d / "fast5")
    names = write_synthetic_dir(fast5, 6, (150, 600), seed=43)
    with open(os.path.join(fast5, BAD), "wb") as fp:
        fp.write(b"this is not an HDF5 file\n" * 8)
    paths = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(430 + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=11, n_classes=nc)), gen)
        paths.append(str(d / f"m{k + 1}.h5"))
        save_keras_weights(p, paths[-1], 11, nc)
    return d, fast5, names, paths


def _cli(folder, tag, *extra):
    from nanoreviser_torch.cli.reviser import main

    d, fast5, _, paths = folder
    out = d / f"out_{tag}"
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        rc = main(["-d", fast5, "-o", str(out), "-F", "fasta",
                   "--revise_mode", "model", "--device", "cpu", "--thread", "2",
                   "--model1_predict_dir", paths[0], "--model2_predict_dir",
                   paths[1], "-e", str(d / f"failed_{tag}.txt"), *extra])
    return rc, {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}


@pytest.fixture(scope="module")
def traced(folder):
    """(rc, files, trace) of a traced CLI run, and (rc, files) untraced."""
    assert trace.TRACER.on is False
    path = folder[0] / "trace.json"
    rc, files = _cli(folder, "on", "--trace_json", str(path))
    assert trace.TRACER.on is False
    with open(path) as fp:
        got = json.load(fp)
    return (rc, files, got), _cli(folder, "off")


def test_cli_trace_json_has_every_span(traced, folder):
    (rc, files, got), _ = traced
    names = folder[2]
    assert rc == 1                                  # the file that is not HDF5
    assert len(files) == len(names)
    calls, secs = got["span_calls"], got["span_s"]
    for name in CLI_SPANS + POOL_SPANS + ENGINE_SPANS:
        assert calls.get(name, 0) > 0, name
        assert secs[name] >= 0.0, name
    for name in CARD_WAITS:
        assert name not in calls, name
    assert calls["engine.add_read"] >= len(names)
    assert calls["cli.write"] == calls["cli.emit"] == len(files)
    assert calls["pool.unpack"] == len(names)
    assert calls["cli.pool_spawn"] == calls["cli.pool_close"] == 1
    c = got["counters"]
    assert c["pool.worker_reads"] == len(names) + 1  # every file prepped
    assert c["pool.worker_s"] > 0.0
    assert secs["cli.emit"] >= secs["cli.write"]


def test_cli_output_identical_traced_and_not(traced):
    (rc_on, on, _), (rc_off, off) = traced
    assert rc_on == rc_off and on == off


def test_no_span_open_across_a_yield(tracer, folder, monkeypatch):
    """A recorder around every span: no engine or pool span inside
    ``cli.emit``, and no span at all open when ``cli.emit`` opens (the
    engine's and the pool's generators have just yielded) or when the
    engine's stream yields to its consumer."""
    from nanoreviser_torch.infer import PrepPool, StreamingReviser

    real, stack, nested, held = trace.span, [], [], []

    @contextlib.contextmanager
    def recorded(name):
        if name == "cli.emit" and stack:
            held.append(tuple(stack))
        if "cli.emit" in stack and name.startswith(("engine.", "pool.")):
            nested.append(name)
        stack.append(name)
        try:
            with real(name):
                yield
        finally:
            stack.pop()

    monkeypatch.setattr(trace, "span", recorded)
    trace.enable(True)
    rc, files = _cli(folder, "recorded")
    assert rc == 1 and files
    assert not nested and not held, (nested, held)

    _, fast5, names, paths = folder
    engine = StreamingReviser(*paths, device="cpu")
    with PrepPool(2) as pool:
        pool.ready()
        prepped = ((fn, w) for fn, w, _ in pool.stream(fast5, names))
        for _ in engine.revise_stream(prepped):
            assert not stack, stack
    assert trace.take()["span_calls"]["engine.merge"] >= len(names)


@pytest.mark.cuda
def test_card_engine_records_its_waits(tracer, folder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nanoreviser_torch.infer import PrepPool, StreamingReviser

    _, fast5, names, paths = folder
    engine = StreamingReviser(*paths, batch_windows=2048, max_in_flight=1,
                              device="cuda")
    trace.enable(True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, PrepPool(2) as pool:
        pool.ready()
        prepped = ((fn, w) for fn, w, _ in pool.stream(fast5, names))
        got = list(engine.revise_stream(prepped))
        torch.cuda.synchronize()
    assert len(got) == len(names)
    calls = trace.take()["span_calls"]
    for name in CARD_WAITS + ENGINE_SPANS[:4]:
        assert calls.get(name, 0) > 0, name
    evs = list(prof.profiler.kineto_results.events())
    marks = {ev.name() for ev in evs if ev.name().startswith("nanorev.")}
    assert {"nanorev.engine.submit", "nanorev.engine.fetch_wait"} <= marks
    assert any("stack_full" in ev.name() for ev in evs)
