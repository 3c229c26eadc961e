"""Finds a cell's parts by name and turns a run's record into the result
line.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration (widths,
  window, classes, the reference that computes it);
* ``portbench/traffic/<mix>.json``: the traffic's parameters, its
  ``entry`` (``portbench/entries/<entry>.py``, whose ``run`` drives the
  program and returns the run's record);
* ``portbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``portbench/metrics/<metric>.py``: ``UNIT`` and ``read(record)``, the
  metric's value or None where the record holds nothing to read.

So a cell, a mix, a configuration or a metric is added with files and
entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nanoreviser_tpu")


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    limits, read from the checkout at ``root``."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.dir = os.path.join(root, "portbench")
        with open(os.path.join(root, "BENCHMARK.json")) as fp:
            self.bench = json.load(fp)
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        entry = next(c for c in self.bench["configs"]
                     if c["name"] == self.workload["config"])
        self.config = _load(os.path.join(root, entry["file"]))
        self.traffic = _load(os.path.join(self.dir, "traffic",
                                          self.workload["traffic"] + ".json"))
        self.limits = _load(os.path.join(self.dir, "limits", name + ".json"))

    def metrics(self, kind: str) -> list[dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics: those that
        list it, or list no cells (per-layer ones then only where the cell
        reports the end-to-end metric they move)."""
        e2e = [m for m in self.bench["end_to_end"] if self._has(m)]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if m.get("workloads") is not None and self.name in m["workloads"]
                or m.get("workloads") is None and m["moves"] in names]

    def _has(self, metric: dict) -> bool:
        return metric.get("workloads") is None or self.name in metric["workloads"]

    def entry(self):
        return _module(os.path.join(self.dir, "entries",
                                    self.traffic["entry"] + ".py"))

    def reader(self, metric: str):
        return _module(os.path.join(self.dir, "metrics", metric + ".py"))


def _load(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def _module(path: str):
    name = "portbench_file_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metric_values(cell: Cell, kind: str, record: dict) -> dict:
    out = {}
    for m in cell.metrics(kind):
        reader = cell.reader(m["name"])
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": reader.UNIT}
    return out


def result_line(cell: Cell, record: dict, trace: bool) -> dict:
    """The last line of a run: ``checks`` (each compared number with its
    limit) comes last."""
    checks = record["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": record["attempted"],
            "failed": record["failed"],
            "metrics": metric_values(cell, "per_layer" if trace else "end_to_end",
                                     record),
            "device": record["device"]}
    if trace and record.get("breakdown"):
        line["breakdown"] = record["breakdown"]
    line["checks"] = checks
    return line
