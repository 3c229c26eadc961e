"""The benchmark of ``nanoreviser_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card(s) of this machine: set-up
(inputs and weights from the seed, one warm pass), then the measured
window, then the comparison with the plain reference that decides
``correct``. The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are also the last
lines of standard error. With ``--trace 1`` the run reports the cell's
per-layer metrics from spans and a profiler trace of the window, else its
end-to-end metrics.

Exits 2 without a result when there is no CUDA card or fewer than the cell
asks for, and 3 when a module of JAX or of the JAX package is loaded after
set-up or before the result (top-level names compared whole).

The top level of this file imports no more than the standard library: the
program's prep pool starts its workers with ``spawn``, which runs this file
again in each of them.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import harness

    cell = harness.Cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {n}", file=sys.stderr)
        return 2
    record = cell.entry().run(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t0=t0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    line = harness.result_line(cell, record, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
