"""Traffic entry ``revise``: directories of single-read fast5 files through
the reviser CLI's model mode, in this process
(``nanoreviser_torch.cli.reviser.main``), closed loop.

Set-up makes the traffic's distinct reads and both models' weights from the
seed and runs one warm pass over the distinct reads. The window is whole
passes over a directory of links to them, back to back, until the window's
seconds have passed, the last pass included; each pass pays the CLI's own
start-up (its prep pool, the weights' load and packing), as a user pays it
for each directory. Every pass writes its own output directory.

``correct``: once the window has closed, the plain reference
(``portbench/reference/``) recomputes every distinct read from the arrays
the benchmark wrote, in float32, and every read written in the window is
judged against it (``portbench.judge``): ``missing`` counts reads without
an output file of the right name and header, or recorded as failed or
degraded (limit 0); ``logit_gap`` is the widest gap by which a label that
the written read needs lies below the reference's best (the limit in
``portbench/limits/<cell>.json``).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from portbench import harness, judge, probes, yardstick
from portbench.inputs import reads as reads_mod
from portbench.inputs import weights as weights_mod
from portbench.reference import reviser as ref


def _model_seed(seed: int, m: int) -> int:
    return int(np.random.SeedSequence([seed, 10 + m]).generate_state(1)[0])


def _cli(src: str, out: str, failed: str, models: tuple, trf: dict,
         device: str) -> int:
    from nanoreviser_torch.cli.reviser import main as cli_main

    argv = ["-d", src, "-o", out, "-F", trf["format"], "-S", "",
            "--revise_mode", "model", "--align", "auto", "--device", device,
            "--thread", str(trf["thread"]), "-e", failed,
            "--model1_predict_dir", models[0], "--model2_predict_dir", models[1]]
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return cli_main(argv)


def setup(cell, seed: int, device: str, tmp: str) -> dict:
    """The inputs of a run: distinct reads, links, weights; no pass."""
    cfg, trf = cell.config, cell.traffic
    ln = trf["lengths"]
    lengths = reads_mod.lognormal_lengths(trf["distinct_reads"], ln["median"],
                                          ln["sigma"], ln["min"], ln["max"])
    distinct = os.path.join(tmp, "distinct")
    names, reads = reads_mod.make_reads(distinct, lengths, seed)
    links = reads_mod.link_dir(
        os.path.join(tmp, "links"), [os.path.join(distinct, n) for n in names],
        reads_mod.copies_per_read(trf["reads_per_pass"], len(names)), seed)
    params = [weights_mod.random_params(cfg, nc, _model_seed(seed, m), device)
              for m, nc in enumerate(cfg["n_classes"])]
    longest = max(range(len(reads)), key=lambda k: len(reads[k].bases))
    rows = [ref.base_rows(reads[longest].events, reads[longest].signal)]
    for m, lg in enumerate(ref.read_logits(params, rows, cfg["window"], device)[0]):
        chars = ref.LABEL_CHARS[m:].tobytes().decode()
        shares = cfg["label_shares"][m]
        weights_mod.set_label_shares(
            params[m], lg, {chars.index(c): v for c, v in shares.items()})
    models = []
    for m, p in enumerate(params):
        path = os.path.join(tmp, f"model{m + 1}.h5")
        weights_mod.save_keras_weights(p, path)
        models.append(path)
    return {"distinct": distinct, "names": names, "reads": reads,
            "links": links, "params": params, "models": tuple(models)}


def window(cell, inputs: dict, seconds: float, trace: bool, device: str,
           tmp: str) -> tuple[list, list, dict | None]:
    """Passes over the links until their seconds add up to ``seconds``;
    returns the passes, the reads each wrote (``collect``) and, traced, the
    device timeline."""
    import torch

    cfg, trf = cell.config, cell.traffic
    n = {k: len(r.bases) for k, r in enumerate(inputs["reads"])}
    per_pass = {"bases": 0, "windows": 0, "rows": 0}
    for k in inputs["links"].values():
        w, rows = yardstick.read_work(cfg, n[k])
        per_pass["bases"] += n[k]
        per_pass["windows"] += w
        per_pass["rows"] += rows
    spans = probes.Spans(profiling=trace) if trace else contextlib.nullcontext()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    passes, outputs = [], []
    out = os.path.join(tmp, "out")
    failed = os.path.join(tmp, "failed.txt")
    with spans, (prof if prof is not None else contextlib.nullcontext()):
        while True:
            k = len(passes)
            mark = (torch.profiler.record_function(probes.PASS) if trace
                    else contextlib.nullcontext())
            with mark:
                t, cpu = time.perf_counter(), time.thread_time()
                rc = _cli(os.path.join(tmp, "links"), out, failed,
                          inputs["models"], trf, device)
                if device == "cuda":
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t
                cpu = time.thread_time() - cpu
            t = time.perf_counter()
            got = collect(inputs, out, failed)
            print(f"portbench pass {k}: {secs:.3f} s, cli thread cpu "
                  f"{cpu:.3f} s, rc {rc}, written/input bases "
                  f"{got['written_bases'] / per_pass['bases']:.4f}, read back "
                  f"and deleted in {time.perf_counter() - t:.3f} s"
                  + (f", spans {json.dumps(spans.seconds)}" if trace else ""),
                  file=sys.stderr)
            outputs.append(got)
            passes.append({"seconds": secs, "cli_thread_cpu_s": cpu, "rc": rc,
                           "written_bases": got["written_bases"], **per_pass,
                           **(spans.take() if trace else {})})
            if sum(p["seconds"] for p in passes) >= seconds:
                break
    return passes, outputs, (probes.timeline(prof)
                             if trace and device == "cuda" else None)


def collect(inputs: dict, out: str, failed: str) -> dict:
    """The reads one pass wrote, then its output directory and failed-read
    list deleted: ``missing``, the reads without an output of the right
    name and header, or recorded as failed; ``got``, the [(distinct read,
    written bases)] of the others (equal texts share one object);
    ``written_bases``, the bases of all of them."""
    failed_names = set()
    if os.path.exists(failed):
        with open(failed) as fp:
            failed_names = {line.split("\t", 1)[0] for line in fp if line.strip()}
    missing, got, seen, written_bases = 0, [], {}, 0
    for name, k in inputs["links"].items():
        path = os.path.join(out, name.split(".")[0] + "_out.fasta")
        try:
            with open(path, "rb") as fp:
                head, _, body = fp.read().partition(b"\n")
        except FileNotFoundError:
            missing += 1
            continue
        if head != b">" + name.encode() or name in failed_names:
            missing += 1
            continue
        item = seen.setdefault((k, body), (k, body))
        got.append(item)
        written_bases += len(body) - body.count(b"\n")
    shutil.rmtree(out, ignore_errors=True)
    if os.path.exists(failed):
        os.remove(failed)
    return {"missing": missing, "got": got, "written_bases": written_bases}


def reference(cell, inputs: dict, device: str, precision: str = "f32"):
    """The reference's base rows and logits of every distinct read."""
    rows = [ref.base_rows(r.events, r.signal) for r in inputs["reads"]]
    return rows, ref.read_logits(inputs["params"], rows, cell.config["window"],
                                 device, precision)


def offsets(cell, inputs: dict, rows: list, logits: list) -> list[int]:
    """The window-centre offset the program calibrates on the first read it
    revises (the first link in sorted order), and any other that labels
    within a near tie of the reference's could give it."""
    t = cell.config["window"]
    first = inputs["links"][sorted(inputs["links"])[0]]
    best, agree = ref.calibrate(rows[first][0], logits[first][0].argmax(1), t)
    near = 0.02
    out = {best}
    top = np.nanmax(agree) if np.isfinite(agree).any() else -1.0
    if top >= 0.5 - near:
        out |= {int(k) for k in np.flatnonzero(agree >= top - near)}
    if top < 0.5 + near:
        out.add((t - 1) // 2)
    return sorted(out)


def widest(rows: list, logits: list, offs: list, texts: list) -> float:
    """The widest gap over the passes, each pass judged at the offset that
    explains it best."""
    unique = sorted({kb for got in texts for kb in got})
    gap = {}
    for off in offs:
        items = [(rows[k][0], logits[k][0], logits[k][1], off, body)
                 for k, body in unique]
        gap.update({(off, kb): g for kb, g in zip(unique, judge.widest_gap(items))})
    return max((min(max((gap[(off, kb)] for kb in got), default=0.0)
                    for off in offs) for got in texts), default=0.0)


def control_reading(cell, inputs: dict, rows: list, logits: list,
                    device: str) -> dict:
    """The control: the reference computed in float8 products, put in the
    program's place (its labels merged into reads at the offset it
    calibrates itself), judged as the program's reads are."""
    _, low = reference(cell, inputs, device, "fp8")
    first = inputs["links"][sorted(inputs["links"])[0]]
    off, _ = ref.calibrate(rows[first][0], low[first][0].argmax(1),
                           cell.config["window"])
    merged = [ref.merge(rows[k][0], l1.argmax(1), l2.argmax(1), off)
              for k, (l1, l2) in enumerate(low)]
    texts = [[(k, merged[k]) for k in inputs["links"].values()]]
    offs = offsets(cell, inputs, rows, logits)
    return {"logit_gap": widest(rows, logits, offs, texts), "offset": off,
            "offsets": offs}


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
                  os.path.join(tmp, "failed_warm.txt"), inputs["models"],
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
            # the peak is the window's: set-up's reference (the label
            # shares) ran on the card before it
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        passes, outputs, tl = window(cell, inputs, seconds, trace, device, tmp)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        t_judge = time.perf_counter()
        rows, logits = reference(cell, inputs, device)
        missing = sum(o["missing"] for o in outputs)
        gap = widest(rows, logits, offsets(cell, inputs, rows, logits),
                     [o["got"] for o in outputs])
        print(f"portbench judge: {time.perf_counter() - t_judge:.3f} s",
              file=sys.stderr)
        low = (control_reading(cell, inputs, rows, logits, device)
               if control else None)
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
            # 1e9 stands for a read that no labels write (JSON has no inf)
            "logit_gap": {"value": gap if np.isfinite(gap) else 1e9,
                          "limit": cell.limits["logit_gap"]["limit"]},
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
