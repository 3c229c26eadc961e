"""What a traced run records: spans around calls into the program's layers,
taken from outside the program, and the device's timeline from
``torch.profiler``.

``Spans`` wraps, for the length of a ``with`` block, the program's
functions at the boundaries of its layers, adds up the seconds spent in
each (and, under the profiler, marks each call with
``record_function("portbench.<span>")``, so that the device's idle gaps
can be put down to what the host was doing), keeps the prep pool's own
start-up time (what ``PrepPool.ready`` returns) and the engines' counters
(``StreamingReviser.stats``). Nothing is wrapped in an untraced run.

``timeline`` reduces the profiler's events of the traced passes to the
device's busy seconds, its time per operation and its idle gaps by span.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time

# (module, attribute path, span)
TARGETS = (
    ("multiprocessing.pool", "ApplyResult.get", "prep_wait"),
    ("nanoreviser_torch.infer.hostpipe", "PrepPool.__init__", "pool_spawn"),
    ("nanoreviser_torch.infer.hostpipe", "PrepPool.ready", "pool_start"),
    ("nanoreviser_torch.infer.streaming", "StreamingReviser.__init__", "engine_init"),
    ("nanoreviser_torch.infer.streaming", "StreamingReviser._add_read", "add_read"),
    ("nanoreviser_torch.infer.streaming", "StreamingReviser._submit", "submit"),
    ("nanoreviser_torch.infer.streaming", "StreamingReviser._fetch", "device_wait"),
    ("nanoreviser_torch.infer.streaming", "StreamingReviser._merge_one", "merge"),
    ("nanoreviser_torch.io", "write_read_fasta", "write"),
)
PASS = "portbench.pass"


class Spans:
    def __init__(self, profiling: bool):
        self.profiling = profiling
        self.seconds: dict = {}
        self.calls: dict = {}
        self.pool_start_s: list = []
        self.engines: list = []
        self._undo: list = []

    def take(self) -> dict:
        """The seconds, calls, pool start-ups and engine counters since the
        last ``take``."""
        out = {"span_s": self.seconds, "span_calls": self.calls,
               "pool_start_s": self.pool_start_s,
               "engines": [dict(e.stats) for e in self.engines]}
        self.seconds, self.calls, self.pool_start_s, self.engines = {}, {}, [], []
        return out

    def _wrap(self, fn, name: str):
        import torch

        spans = self

        def wrapper(*args, **kwargs):
            mark = (torch.profiler.record_function("portbench." + name)
                    if spans.profiling else contextlib.nullcontext())
            t = time.perf_counter()
            try:
                with mark:
                    out = fn(*args, **kwargs)
            finally:
                spans.seconds[name] = spans.seconds.get(name, 0.0) + (
                    time.perf_counter() - t)
                spans.calls[name] = spans.calls.get(name, 0) + 1
            if name == "engine_init":
                spans.engines.append(args[0])
            elif name == "pool_start":
                spans.pool_start_s.append(out)
            return out
        return wrapper

    def __enter__(self):
        for module, path, name in TARGETS:
            owner = importlib.import_module(module)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            setattr(owner, attr, self._wrap(fn, name))
            self._undo.append((owner, attr, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def _ns(ev, which: str) -> int:
    if which == "start":
        return ev.start_ns() if hasattr(ev, "start_ns") else 1000 * ev.start_us()
    return ev.duration_ns() if hasattr(ev, "duration_ns") else 1000 * ev.duration_us()


def timeline(prof) -> dict | None:
    """The device's busy seconds, window seconds (the ``portbench.pass``
    spans), seconds and launches per operation, and idle seconds by the
    ``portbench.*`` span the host was in, over the traced passes;
    None when the trace holds no device operation."""
    from torch.autograd import DeviceType

    passes, spans, dev = [], [], []
    for ev in prof.profiler.kineto_results.events():
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith("portbench."):    # not a range's GPU copy
                dev.append((start, start + dur, name))
        elif name == PASS:
            passes.append((start, start + dur))
        elif name.startswith("portbench."):
            spans.append((start, start + dur, name[len("portbench."):]))
    if not dev or not passes:
        return None
    passes.sort()
    dev.sort()
    spans.sort()
    ops: dict = {}
    busy = 0
    gaps: dict = {}
    span_starts = [s[0] for s in spans]

    def label(t: int) -> str:
        """The span around instant t: the wrapped calls do not nest, so the
        last one to start before t, if it has not ended."""
        i = bisect.bisect_right(span_starts, t) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return "other"

    for p0, p1 in passes:
        cursor = p0
        for s, e, name in dev:
            s, e = max(s, p0), min(e, p1)
            if e <= s:
                continue
            rec = ops.setdefault(name, [0, 0])
            rec[0] += e - s
            rec[1] += 1
            if s > cursor:
                lab = label((cursor + s) // 2)
                gaps[lab] = gaps.get(lab, 0) + (s - cursor)
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
        if p1 > cursor:
            lab = label((cursor + p1) // 2)
            gaps[lab] = gaps.get(lab, 0) + (p1 - cursor)
    window = sum(p1 - p0 for p0, p1 in passes)
    return {"busy_s": busy * 1e-9, "window_s": window * 1e-9,
            "ops": {k: v[0] * 1e-9 for k, v in ops.items()},
            "launches": {k: v[1] for k, v in ops.items()},
            "idle": {k: v * 1e-9 for k, v in gaps.items()}}


def breakdown(tl: dict) -> dict:
    """The ten device operations that took most time and the ten largest
    idle shares by span, as the result line carries them (names cut to 96
    characters: a kernel's template arguments run to hundreds)."""
    def top(d):
        return [[k[:96], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(tl["ops"]), "idle_gaps": top(tl["idle"])}
