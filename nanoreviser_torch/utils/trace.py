"""Spans and counters of the port's host work, off unless switched on.

    from nanoreviser_torch.utils import trace

    with trace.span("engine.merge"):
        ...
    trace.count("pool.worker_reads", n)
    was = trace.enable(True)
    ...
    got = trace.take()      # {"span_s": {}, "span_calls": {}, "counters": {}}
    trace.enable(was)

Off (the default), ``span`` checks one flag and returns a shared no-op
object, and ``count`` checks the same flag: nothing is timed, allocated or
recorded. On, each span adds its ``time.perf_counter`` seconds and one call
to its name; seconds are inclusive, so a span nested in another counts in
both. While a ``torch.profiler`` is also running, each span is a
profiler range ``nanorev.<name>`` too (``_RecordFunctionFast``: ≈ 2 µs a
span on a CPU core, against ≈ 15 µs for ``record_function``, most of which
lies outside the range it records), which puts the host's spans on the
profiler's clock beside the device's kernels.

The tracer is one per process and is not locked: spans and counters belong
to the thread that drives the CLI. A span is never held open across a
``yield``, or a generator's span would swallow its consumer's work.
"""

from __future__ import annotations

import sys
import time

PREFIX = "nanorev."


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "t0", "mark")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name
        self.mark = None

    def __enter__(self):
        torch = sys.modules.get("torch")     # no torch loaded: no profiler
        if torch is not None and torch._C._autograd._profiler_enabled():
            self.mark = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.mark is not None:
            self.mark.__exit__(*exc)
        t = self.tracer
        t.seconds[self.name] = t.seconds.get(self.name, 0.0) + dt
        t.calls[self.name] = t.calls.get(self.name, 0) + 1
        return False


class Tracer:
    """Seconds and calls per span name and totals per counter name, since
    the last ``take``."""

    def __init__(self):
        self.on = False
        self.seconds: dict = {}
        self.calls: dict = {}
        self.counters: dict = {}

    def span(self, name: str):
        if not self.on:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n=1) -> None:
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + n

    def enable(self, on: bool = True) -> bool:
        """Switch tracing on or off; returns whether it was on."""
        was, self.on = self.on, bool(on)
        return was

    def take(self) -> dict:
        """What was recorded since the last ``take``, which starts anew."""
        out = {"span_s": self.seconds, "span_calls": self.calls,
               "counters": self.counters}
        self.seconds, self.calls, self.counters = {}, {}, {}
        return out


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
enable = TRACER.enable
take = TRACER.take
