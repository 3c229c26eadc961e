"""Traffic entry ``basecall``: directories of single-read fast5 files through
the reviser CLI's basecaller mode with an in-process CRF-CTC model
(``--revise_mode basecaller --basecaller_model``;
``nanoreviser_torch.cli.reviser.main``), in this process, closed loop.

Set-up makes the traffic's distinct reads and the model's weights from the
seed (a Bonito model directory: ``config.toml`` and ``weights_1.tar``) and
runs one warm pass over the distinct reads. The window is whole passes
over a directory of links to them, back to back, until the window's
seconds have passed, the last pass included; each pass pays the CLI's own
start-up (its prep pool, the weights' load), as a user pays it for each
directory. The reads are written as fasta and read back by the ``revise``
entry's ``collect``. The record has the shape of the ``revise`` entry's: per pass
its seconds and the bases of the reads it read (``bases``), so that
``revised_bases_per_s`` and ``setup_s`` read it unchanged; also each pass's
samples and chunks (``portbench.crf_yardstick``). Traced, the program's
own tracer (``nanoreviser_torch.utils.trace``) is on over the passes and
each pass keeps its ``take()``, and ``probes.Spans`` adds, as in the
``revise`` entry, the prep pool's start-up (``pool_start_s``) and the
seconds blocked on its results (``span_s["prep_wait"]``) without profiler
marks; the profiler's timeline gives the device's
busy time, its time per operation, the device time of the kernels launched
inside the program's ``basecall.lstm`` spans, and the idle gaps by the
innermost program span the host was in, over the window's first pass (the
profiler cannot hold a window's ~8 M events; the passes are alike).

``correct``: once the window has closed, the plain reference
(``portbench/reference/crf.py``, float32, TF32 off) basecalls every
distinct read from the signals the benchmark wrote, and every read written
in the window is judged against it: ``missing`` counts reads without an
output file of the right name and header, or recorded as failed or
degraded (limit 0); ``edit_rate`` is the largest, over the reads written,
of the edit distance to the reference's read (``portbench.edits``) over
the reference read's length (the limit in ``portbench/limits/<cell>.json``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from portbench import crf_yardstick, edits, harness, probes
from portbench.entries.revise import collect
from portbench.inputs import reads as reads_mod
from portbench.reference import crf as ref

PASS = "portbench.pass"
LSTM_SPAN = "nanorev.basecall.lstm"
CENTRE_READS = 8        # reads whose first chunks centre the linear layer
MODEL_KEYS = ("features", "n_layers", "stride", "winlen", "state_len", "scale",
              "blank_score", "chunksize", "overlap")


def _model_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 20]).generate_state(1)[0])


def random_state(cfg: dict, seed: int, signals: list) -> dict:
    """Bonito's state dict from the seed: PyTorch's uniform bounds
    (1 / sqrt(fan-in)) times the configuration's ``weight_gain`` for the
    convolutions and LSTMs and ``linear_gain`` for the linear layer's
    weights. The linear layer's biases centre each column:
    ``linear_bias`` less the column's weights times the last LSTM's mean
    output over the first chunk of each of ``signals`` (the reference's
    float32 encoder). Left random, a column's fixed offset outweighs what
    the read moves, and on some seeds the decode writes the same repeats
    whatever the read (there the float8 control changes almost nothing)."""
    import torch

    g = torch.Generator().manual_seed(_model_seed(seed))
    h, wg = cfg["features"], cfg["assumed_weights"]

    def u(shape, fan_in, gain):
        return (torch.rand(shape, generator=g) * 2 - 1) * (gain / fan_in ** 0.5)

    st = {}
    for i, (ci, co, k) in enumerate(((1, 4, 5), (4, 16, 5),
                                     (16, h, cfg["winlen"]))):
        st[f"encoder.{i}.conv.weight"] = u((co, ci, k), ci * k, wg["weight_gain"])
        st[f"encoder.{i}.conv.bias"] = u((co,), ci * k, wg["weight_gain"])
    for i in range(cfg["n_layers"]):
        p = f"encoder.{4 + i}.rnn."
        for name, shape in (("weight_ih_l0", (4 * h, h)), ("weight_hh_l0", (4 * h, h)),
                            ("bias_ih_l0", (4 * h,)), ("bias_hh_l0", (4 * h,))):
            st[p + name] = u(shape, h, wg["weight_gain"])
    lin = f"encoder.{4 + cfg['n_layers']}.linear."
    moves = 4 ** (cfg["state_len"] + 1)
    st[lin + "weight"] = u((moves, h), h, wg["linear_gain"])
    firsts = np.stack([ref.chunk(ref.normalise(s), cfg["chunksize"],
                                 cfg["overlap"])[0][0] for s in signals])
    with torch.no_grad():
        mean_h = ref.hidden(ref.Ops("f32"), st, cfg,
                            torch.from_numpy(firsts)).mean((0, 1))
    st[lin + "bias"] = wg["linear_bias"] - st[lin + "weight"] @ mean_h
    return st


def write_model(cfg: dict, state: dict, path: str) -> None:
    """A Bonito model directory, as Bonito's ``config.toml`` names things."""
    import torch

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.toml"), "w") as fp:
        fp.write(
            '[model]\npackage = "bonito.crf"\n\n'
            '[labels]\nlabels = ["N", "A", "C", "G", "T"]\n\n'
            '[input]\nfeatures = 1\n\n'
            f'[global_norm]\nstate_len = {cfg["state_len"]}\n\n'
            f'[encoder]\nactivation = "{cfg["activation"]}"\n'
            f'rnn_type = "{cfg["rnn_type"]}"\nfeatures = {cfg["features"]}\n'
            f'stride = {cfg["stride"]}\nwinlen = {cfg["winlen"]}\n'
            f'scale = {float(cfg["scale"])!r}\n'
            f'blank_score = {float(cfg["blank_score"])!r}\n\n'
            f'[basecaller]\nchunksize = {cfg["chunksize"]}\n'
            f'overlap = {cfg["overlap"]}\n')
    torch.save(state, os.path.join(path, "weights_1.tar"))


def _cli(src: str, out: str, failed: str, model_dir: str, trf: dict,
         device: str) -> int:
    from nanoreviser_torch.cli.reviser import main as cli_main

    argv = ["-d", src, "-o", out, "-F", trf["format"], "-S", "",
            "--revise_mode", "basecaller", "--basecaller_model", model_dir,
            "--device", device, "--thread", str(trf["thread"]), "-e", failed]
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        try:
            return cli_main(argv)
        except SystemExit as exc:      # a CLI that does not know the flags
            return exc.code if isinstance(exc.code, int) else 2


def setup(cell, seed: int, device: str, tmp: str) -> dict:
    """The inputs of a run: distinct reads, links, the model; no pass."""
    cfg, trf = cell.config, cell.traffic
    ln = trf["lengths"]
    lengths = reads_mod.lognormal_lengths(trf["distinct_reads"], ln["median"],
                                          ln["sigma"], ln["min"], ln["max"])
    distinct = os.path.join(tmp, "distinct")
    names, reads = reads_mod.make_reads(distinct, lengths, seed)
    links = reads_mod.link_dir(
        os.path.join(tmp, "links"), [os.path.join(distinct, n) for n in names],
        reads_mod.copies_per_read(trf["reads_per_pass"], len(names)), seed)
    state = random_state(cfg, seed,
                         [r.signal for r in reads[:CENTRE_READS]])
    model_dir = os.path.join(tmp, "model")
    write_model(cfg, state, model_dir)
    return {"distinct": distinct, "names": names, "reads": reads,
            "links": links, "state": state, "model": model_dir}


def window(cell, inputs: dict, seconds: float, trace: bool, device: str,
           tmp: str) -> tuple[list, list, dict | None]:
    """Passes over the links until their seconds add up to ``seconds``;
    returns the passes, the reads each wrote (``collect``) and, traced, the
    device timeline of the first pass (a pass launches ~1.6 M kernels and
    runtime calls, most of them cuDNN's per-step LSTM kernels: the
    profiler holds one pass's, not a window's)."""
    import torch

    cfg, trf = cell.config, cell.traffic
    per_pass = {"bases": 0, "samples": 0, "chunks": 0}
    for k in inputs["links"].values():
        r = inputs["reads"][k]
        per_pass["bases"] += len(r.bases)
        per_pass["samples"] += len(r.signal)
        per_pass["chunks"] += crf_yardstick.read_chunks(cfg, len(r.signal))
    tracer = None
    if trace:
        try:
            from nanoreviser_torch.utils import trace as tracer
        except ImportError:
            tracer = None
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    spans = probes.Spans(profiling=False) if trace else None
    was = tracer.enable(True) if tracer is not None else None
    if tracer is not None:
        tracer.take()
    passes, outputs = [], []
    out = os.path.join(tmp, "out")
    failed = os.path.join(tmp, "failed.txt")
    try:
        if spans is not None:
            spans.__enter__()
        if prof is not None:
            prof.start()
        while True:
            k = len(passes)
            profiled = prof is not None and k == 0
            mark = (torch.profiler.record_function(PASS) if profiled
                    else contextlib.nullcontext())
            with mark:
                t, cpu = time.perf_counter(), time.thread_time()
                rc = _cli(os.path.join(tmp, "links"), out, failed,
                          inputs["model"], trf, device)
                if device == "cuda":
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t
                cpu = time.thread_time() - cpu
            if profiled:
                prof.stop()
            took = tracer.take() if tracer is not None else None
            t = time.perf_counter()
            got = collect(inputs, out, failed)
            print(f"portbench pass {k}: {secs:.3f} s, cli thread cpu "
                  f"{cpu:.3f} s, rc {rc}, written/input bases "
                  f"{got['written_bases'] / per_pass['bases']:.4f}, read "
                  f"back and deleted in {time.perf_counter() - t:.3f} s"
                  + (f", tracer {json.dumps(took)}" if took else ""),
                  file=sys.stderr)
            outputs.append(got)
            passes.append({"seconds": secs, "cli_thread_cpu_s": cpu,
                           "rc": rc, "written_bases": got["written_bases"],
                           **per_pass, "profiled": profiled,
                           **({"tracer": took} if took is not None else {}),
                           **(spans.take() if spans is not None else {})})
            if sum(p["seconds"] for p in passes) >= seconds:
                break
    finally:
        if spans is not None:
            spans.__exit__(None, None, None)
        if tracer is not None:
            tracer.enable(was)
    return passes, outputs, (timeline(prof)
                             if trace and device == "cuda" else None)


def timeline(prof) -> dict | None:
    """The device's busy seconds, window seconds (the ``portbench.pass``
    spans), seconds and launches per operation, the device seconds of the
    kernels launched inside the program's ``basecall.lstm`` spans
    (``span_device_s``), and idle seconds by the innermost ``nanorev.*``
    span the host was in at each gap's midpoint, over the traced passes;
    None when the trace holds no device operation."""
    from torch.autograd import DeviceType

    passes, dev, spans, lstm, launched = [], [], [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not (ev.is_user_annotation() or name.startswith(("portbench.",
                                                                "nanorev."))):
                dev.append((start, start + dur, name, ev.correlation_id()))
        elif name == PASS:
            passes.append((start, start + dur))
        elif name.startswith("nanorev."):
            spans.append((start, start + dur, name[len("nanorev."):]))
            if name == LSTM_SPAN:
                lstm.append((start, start + dur))
        elif name.startswith("cu"):
            launched[ev.correlation_id()] = start
    if not dev or not passes:
        return None
    passes.sort()
    dev.sort()
    spans.sort()
    lstm.sort()
    span_starts = [s[0] for s in spans]
    lstm_starts = [s[0] for s in lstm]

    def innermost(t: int) -> str:
        """The latest-starting span that holds t (spans nest)."""
        i = bisect.bisect_right(span_starts, t) - 1
        for j in range(i, max(i - 256, -1), -1):
            if spans[j][1] >= t:
                return spans[j][2]
        return "other"

    def in_lstm(t: int) -> bool:
        i = bisect.bisect_right(lstm_starts, t) - 1
        return i >= 0 and lstm[i][1] >= t

    ops: dict = {}
    gaps: dict = {}
    busy = lstm_s = 0
    for p0, p1 in passes:
        cursor = p0
        for s, e, name, corr in dev:
            s, e = max(s, p0), min(e, p1)
            if e <= s:
                continue
            rec = ops.setdefault(name, [0, 0])
            rec[0] += e - s
            rec[1] += 1
            at = launched.get(corr)
            if at is not None and in_lstm(at):
                lstm_s += e - s
            if s > cursor:
                lab = innermost((cursor + s) // 2)
                gaps[lab] = gaps.get(lab, 0) + (s - cursor)
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
        if p1 > cursor:
            lab = innermost((cursor + p1) // 2)
            gaps[lab] = gaps.get(lab, 0) + (p1 - cursor)
    window_ns = sum(p1 - p0 for p0, p1 in passes)
    return {"busy_s": busy * 1e-9, "window_s": window_ns * 1e-9,
            "ops": {k: v[0] * 1e-9 for k, v in ops.items()},
            "launches": {k: v[1] for k, v in ops.items()},
            "span_device_s": {"basecall.lstm": lstm_s * 1e-9} if lstm else {},
            "idle": {k: v * 1e-9 for k, v in gaps.items()}}


def reference(cell, inputs: dict, device: str, precision: str = "f32") -> list:
    """The reference's read (bytes, or None where its trimmed read is empty)
    of every distinct read."""
    cfg = {k: cell.config[k] for k in MODEL_KEYS}
    got = ref.basecall_reads(inputs["state"], cfg,
                             [r.signal for r in inputs["reads"]], device,
                             precision, block=512)
    return [None if s is None else s.encode() for s, _ in got]


def widest(texts: list, want: list) -> float:
    """The largest edit distance over the reference read's length, over
    the reads written (1e9 where the reference writes nothing); the three
    widest go to standard error."""
    unique = sorted({kb for got in texts for kb in got})
    pairs = [(body, want[k]) for k, body in unique if want[k]]
    dist = iter(edits.distances(pairs))
    rates = []
    for k, body in unique:
        d = next(dist) if want[k] else None
        rates.append((d / len(want[k]) if want[k] else 1e9, k,
                      len(want[k] or b""), d))
    rates.sort(reverse=True)
    print("portbench widest (rate, read, reference length, distance): "
          + json.dumps(rates[:3]), file=sys.stderr)
    return rates[0][0] if rates else 0.0


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t0: float, control: bool = False) -> dict:
    """Set-up, the window and the judge; with ``control``, the record's
    ``control`` also holds the control's reading on the same inputs
    (``portbench/calibrate.py``; the benchmark's runs do not take it)."""
    import torch

    cfg = cell.config
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        if device == "cuda":
            torch.cuda.init()
        inputs = setup(cell, seed, device, tmp)
        rc = _cli(inputs["distinct"], os.path.join(tmp, "warm"),
                  os.path.join(tmp, "failed_warm.txt"), inputs["model"],
                  cell.traffic, device)
        if rc != 0:
            raise RuntimeError(f"the warm pass returned {rc}")
        if device == "cuda":
            torch.cuda.synchronize()
        shutil.rmtree(os.path.join(tmp, "warm"))
        found = harness.forbidden_modules()
        if found:
            print(f"portbench: loaded modules of JAX or the JAX package after "
                  f"set-up: {found}", file=sys.stderr)
            raise SystemExit(3)
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        passes, outputs, tl = window(cell, inputs, seconds, trace, device, tmp)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        t_judge = time.perf_counter()
        want = reference(cell, inputs, device)
        missing = sum(o["missing"] for o in outputs)
        texts = [o["got"] for o in outputs]
        rate = widest(texts, want)
        print(f"portbench judge: {time.perf_counter() - t_judge:.3f} s, "
              f"{len({kb for got in texts for kb in got})} distinct texts",
              file=sys.stderr)
        low = None
        if control:
            fp8 = reference(cell, inputs, device, "fp8")
            low = {"edit_rate": widest(
                [[(k, fp8[k]) for k in inputs["links"].values() if fp8[k]]],
                want)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    window_s = sum(p["seconds"] for p in passes)
    n_links = len(inputs["links"])
    record = {
        "config": cfg, "setup_s": setup_s, "window_s": window_s,
        "passes": passes, "trace": tl,
        "attempted": n_links * len(passes), "failed": missing,
        "checks": {
            "missing": {"value": missing, "limit": 0},
            "edit_rate": {"value": rate,
                          "limit": cell.limits["edit_rate"]["limit"]},
        },
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": peak,
        },
    }
    if tl is not None:
        record["device"]["busy_s"] = tl["busy_s"]
        record["device"]["window_s"] = tl["window_s"]
        record["breakdown"] = probes.breakdown(tl)
    if low is not None:
        record["control"] = low
    return record
