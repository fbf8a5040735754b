"""Readings of the check's numbers over many seeds, for setting and
testing the limits: each seed is one run of the cell with a zero-second
window (one pass over its pool), optionally under a control or a fault
(`controls.py`), all in one process.

    python -m benchmark.readings --workload <cell> --seeds 1,2,3 [--control <name>] [--out <file>]

Prints one JSON line per seed: the seed, the control, `correct`, every
judged number (`numbers`), the checks and the run's metrics. Runs on the
card when it has one, else on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import controls, manifest, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", default="none")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = manifest.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with controls.applied(args.control):
            res = run.run(cell, seed, 0, False, device, t_process=t0)
        line = json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control, "device": res["device"]["kind"],
            "correct": res["correct"], "failed": res["failed"], "numbers": res["numbers"],
            "checks": res["checks"], "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "seconds": time.perf_counter() - t0,
        })
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
