"""Stage seconds of the PyTorch port's default run on one GPU, for one tree
of the repo or for two trees taken in turns.

One tree (the default: the tree this script lies in, or --root DIR): builds
the smoke dataset of `chip_smoke.py` (300 kb x 3 strains, 30x, 10% error,
seed 7), runs the port's CLI once to warm up and then --runs times, and
prints one JSON line per run: {"root", "run", "wall", "stages": {...}}.

Two trees (--trees A B, e.g. a `git archive` of the parent commit and the
working tree): runs itself on A, B, B, A, each in a process of its own so
that every tree builds and loads its own kernels, and prints the stage
table of all runs side by side. Host times on a shared machine spread by
seconds from run to run; compare trees only within one such call.

Usage (on a machine with a CUDA GPU):
    python scripts/torch_stage_times.py [--root DIR] [--runs N]
    python scripts/torch_stage_times.py --trees PARENT_DIR CHANGE_DIR [--runs N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str, runs: int) -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    from chip_smoke import build_dataset
    from hairsplitter_tpu_torch import cli

    with tempfile.TemporaryDirectory(prefix="hs_stages_") as tmp:
        asm, reads, _, _ = build_dataset(tmp)
        for run in range(runs + 1):  # run 0 warms up (kernel builds, caches)
            out = os.path.join(tmp, f"out{run}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["-i", asm, "-f", reads, "-o", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"CLI returned {rc}")
            with open(os.path.join(out, "stage_stats.json")) as f:
                stages = {k: v["seconds"] for k, v in json.load(f).items()}
            if run > 0:
                print("STAGES " + json.dumps({"root": root, "run": run, "wall": wall, "stages": stages}), flush=True)
    return 0


def in_turns(trees: list[str], runs: int) -> int:
    a, b = (os.path.abspath(t) for t in trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    columns = []
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root, "--runs", str(runs)],
            cwd=root, capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("STAGES "):
                columns.append((label, json.loads(line[7:])))
    print(f"A = {a}\nB = {b}\norder of the columns = order of the runs")
    names = list(columns[0][1]["stages"])
    print(f"{'stage':22s}" + "".join(f"{label + str(c['run']):>10s}" for label, c in columns))
    for name in names:
        print(f"{name:22s}" + "".join(f"{c['stages'].get(name, float('nan')):10.3f}" for _, c in columns))
    print(f"{'wall':22s}" + "".join(f"{c['wall']:10.3f}" for _, c in columns))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="tree of the repo to measure")
    ap.add_argument("--runs", type=int, default=2, help="measured runs after the warm-up")
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"), help="two trees to run in turns A, B, B, A")
    args = ap.parse_args()
    if args.trees:
        return in_turns(args.trees, args.runs)
    return measure(os.path.abspath(args.root), args.runs)


if __name__ == "__main__":
    sys.exit(main())
