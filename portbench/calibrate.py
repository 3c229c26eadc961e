"""The readings a revision cell's ``logit_gap`` limit is set from, on the
card, at the cell's own size and load, several seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--control-seeds 3]

Per seed: a run of the cell whose window is one pass of the CLI over the
cell's directory (its whole load), judged as every run is: the program's
reading. On the first ``--control-seeds`` seeds, also the control: the
reference itself computed in float8 (e4m3) products in the program's
place, its labels merged into reads and judged the same way, on the same
inputs. One JSON line per seed and side. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from portbench import harness

    cell = harness.Cell(root, args.workload)
    entry = cell.entry()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        control = i < args.control_seeds
        rec = entry.run(cell, seed=seed, seconds=0.0, trace=False,
                        device=args.device, t0=time.perf_counter(),
                        control=control)
        sides = [("program", {k: c["value"] for k, c in rec["checks"].items()})]
        if control:
            sides.append(("control", rec["control"]))
        for side, reading in sides:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"calibrate: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
