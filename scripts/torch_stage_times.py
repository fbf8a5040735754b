"""Stage seconds of the PyTorch port's default run on one GPU, for one tree
of the repo or for two trees taken in turns: the counterpart of
`scripts/bench_pipeline.py`.

One tree (the default: the tree this script lies in, or --root DIR): builds
`bench_pipeline.py`'s dataset (by default the smoke dataset of
`chip_smoke.py`: 300 kb x 3 strains at 1% divergence, 30x of 8 kb reads, 10%
error, seed 7), runs the port's CLI once to warm up and then --runs times,
and prints one JSON line per run: {"root", "run", "wall", "read_kbp_per_s",
"stages": {...}}, then the last run's stage table. --profile runs the last
run under cProfile and prints its 45 costliest functions (cumulative).

Two trees (--trees A B, e.g. a `git archive` of the parent commit and the
working tree): runs itself on A, B, B, A, each in a process of its own so
that every tree builds and loads its own kernels, and prints the stage
table of all runs side by side. Host times on a shared machine spread by
seconds from run to run; compare trees only within one such call.

Usage (on a machine with a CUDA GPU):
    python scripts/torch_stage_times.py [--root DIR] [--runs N] [--profile]
        [--length 300000] [--strains 3] [--coverage 30] [--err 0.10] [--seed 7]
    python scripts/torch_stage_times.py --trees PARENT_DIR CHANGE_DIR [--runs N] [dataset flags]
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


def build_dataset(root: str, length: int, strains: int, coverage: float, err: float, seed: int):
    """`scripts/bench_pipeline.py:build_dataset` through the port's own
    simulator: `strains` haplotypes at 1% divergence, `coverage` in all of
    8 kb reads; the assembly is the first strain. Returns (assembly path,
    reads path, read bases)."""
    import numpy as np

    from hairsplitter_tpu_torch.io.fasta import write_fasta
    from hairsplitter_tpu_torch.utils import sim

    rng = np.random.default_rng(seed)
    haps = sim.make_haplotypes(length, strains, 0.01, rng)
    reads = sim.simulate_reads(
        haps, coverage=coverage / strains, read_len=8000, rng=rng,
        sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
    )
    asm_path = os.path.join(root, "assembly.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm_path, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, sum(map(len, reads.seqs))


def measure(root: str, runs: int, data: dict, profile: bool = False) -> int:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    from hairsplitter_tpu_torch import cli

    with tempfile.TemporaryDirectory(prefix="hs_stages_") as tmp:
        asm, reads, read_bases = build_dataset(tmp, **data)
        print(f"dataset: {data['length'] / 1000:.0f} kb x {data['strains']} strains, {data['coverage']:.0f}x, "
              f"{data['err']:.0%} err, seed {data['seed']}, {read_bases / 1000:.0f} read-kbp", flush=True)
        for run in range(runs + 1):  # run 0 warms up (kernel builds, caches)
            out = os.path.join(tmp, f"out{run}")
            prof = None
            if profile and run == runs:
                import cProfile

                prof = cProfile.Profile()
                prof.enable()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["-i", asm, "-f", reads, "-o", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.disable()
                import pstats

                pstats.Stats(prof).sort_stats("cumulative").print_stats(45)
            if rc != 0:
                raise RuntimeError(f"CLI returned {rc}")
            with open(os.path.join(out, "stage_stats.json")) as f:
                stats = json.load(f)
            stages = {k: v["seconds"] for k, v in stats.items()}
            if run > 0:
                print("STAGES " + json.dumps({"root": root, "run": run, "wall": wall,
                                              "read_kbp_per_s": read_bases / 1000 / wall, "stages": stages}),
                      flush=True)
        print("last run's stage table:")
        for stage, entry in stats.items():
            rates = ", ".join(f"{k}={v}" for k, v in entry.items() if k != "seconds")
            print(f"  {stage:24s} {entry['seconds']:7.3f}s  {rates}")
    return 0


def in_turns(trees: list[str], runs: int, data_argv: list[str]) -> int:
    a, b = (os.path.abspath(t) for t in trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}")
    columns = []
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root, "--runs", str(runs), *data_argv],
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
    ap.add_argument("--profile", action="store_true", help="cProfile the last run and print its top functions")
    ap.add_argument("--length", type=int, default=300_000)
    ap.add_argument("--strains", type=int, default=3)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--err", type=float, default=0.10)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    data = dict(length=args.length, strains=args.strains, coverage=args.coverage, err=args.err, seed=args.seed)
    if args.trees:
        return in_turns(args.trees, args.runs, [f"--{k}={v}" for k, v in data.items()])
    return measure(os.path.abspath(args.root), args.runs, data, args.profile)


if __name__ == "__main__":
    sys.exit(main())
