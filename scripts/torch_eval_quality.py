"""Quality scenarios of `scripts/eval_quality.py`, run through the PyTorch
port (`hairsplitter_tpu_torch`) on one GPU.

  metagenome : 10 contigs x 100 kb, 2-3 strains each (25 strains, 1%
               divergence), 30x total coverage per contig, 10%-err 8 kb
               reads. Targets: <=35 contigs, N50 >= 120 kb, min strain
               recovery >= 0.95, <=1 switch error.
  skewed     : 3 strains x 100 kb, abundances 1.0/0.5/0.17 at 30x base
               (rare strain ~5x absolute). Target: rare recovery >= 0.9,
               0 switches.

The data comes from the port's own simulators (`utils/sim`, or
`utils/sim2` with --sim2), built exactly as `scripts/eval_quality.py`
builds it, and goes through the port's `run_pipeline`. Prints one JSON
line: the metrics of `eval_quality.py`, plus the fused K1 launches of the
run, its stage seconds (`stage_stats.json`) and the read count and bases.

Usage (on a machine with a CUDA GPU; `--device cpu` runs the plain PyTorch
versions on the CPU):
    python scripts/torch_eval_quality.py metagenome [--species 10] [--sim2]
    python scripts/torch_eval_quality.py skewed [--rare-cov 5] [--sim2]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hairsplitter_tpu_torch  # noqa: F401,E402  (TF32 off before any torch work)
from hairsplitter_tpu_torch.io.fasta import write_fasta  # noqa: E402
from hairsplitter_tpu_torch.io.gfa import AssemblyGraph, parse_gfa, write_gfa  # noqa: E402
from hairsplitter_tpu_torch.utils import sim as S  # noqa: E402
from hairsplitter_tpu_torch.utils import sim2  # noqa: E402
from hairsplitter_tpu_torch.utils.evaluate import evaluate_phasing  # noqa: E402


def _n50(lengths: list[int]) -> int:
    lengths = sorted(lengths, reverse=True)
    total = sum(lengths)
    acc = 0
    for l in lengths:
        acc += l
        if acc * 2 >= total:
            return l
    return 0


def build_metagenome(root: str, seed: int, n_species: int = 10, length: int = 100_000,
                     coverage: float = 30.0, err: float = 0.10, use_sim2: bool = False):
    """Writes `asm.gfa` (one collapsed contig per species) and `reads.fasta`
    under `root`. Returns (assembly path, reads path, strains of each
    species, number of reads, read bases)."""
    rng = np.random.default_rng(seed)
    species = []
    strain_counts = [2, 3] * (n_species // 2) + [2] * (n_species % 2)
    for ns in strain_counts:
        base = S.random_genome(length, rng)
        species.append([base] + [S.mutate(base, 0.01, rng)[0] for _ in range(ns - 1)])

    asm = AssemblyGraph()
    per_species_reads = []
    for si, strains in enumerate(species):
        asm.add_segment(f"sp{si}", strains[0], depth=coverage)
        if use_sim2:
            per_species_reads.append(sim2.generate(strains, coverage=coverage / len(strains), seed=seed * 100 + si))
        else:
            per_species_reads.append(S.simulate_reads(
                strains, coverage=coverage / len(strains), read_len=8000, rng=rng,
                sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
                uniform_edges=True,
            ))
    all_names, all_seqs = [], []
    for si, r in enumerate(per_species_reads):
        for n, s in zip(r.names, r.seqs):
            all_names.append(f"sp{si}_{n}")
            all_seqs.append(s)
    reads = S.SimReads(all_names, all_seqs, [0] * len(all_seqs), [0] * len(all_seqs), [1] * len(all_seqs))
    asm_path = os.path.join(root, "asm.gfa")
    reads_path = os.path.join(root, "reads.fasta")
    write_gfa(asm, asm_path)
    S.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, species, len(all_seqs), sum(map(len, all_seqs))


def score_metagenome(final: str, species) -> dict:
    """Contigs, N50 and, per species against its own strains, recovery and
    switch errors (contigs assigned by name, as `eval_quality.py` does)."""
    g = parse_gfa(final)
    recoveries: list[float] = []
    switches = 0
    for si, strains in enumerate(species):
        contigs_here = {
            n: s for n, s in g.segments.items()
            if n.startswith(f"sp{si}_") or n.split("-")[0].startswith(f"sp{si}")
        }
        if not contigs_here:
            contigs_here = dict(g.segments)
        ev = evaluate_phasing(contigs_here, strains)
        recoveries.extend(ev.haplotype_recovery)
        switches += ev.total_switch_errors
    return {
        "contigs": len(g.segments),
        "n50": _n50([len(s) for s in g.segments.values()]),
        "recovery_mean": round(float(np.mean(recoveries)), 4),
        "recovery_min": round(float(np.min(recoveries)), 4),
        "switches": switches,
    }


def build_skewed(root: str, seed: int, length: int = 100_000, base_cov: float = 30.0,
                 rare_cov: float = 5.0, err: float = 0.10, use_sim2: bool = False):
    """Writes `asm.fasta` (the first strain) and `reads.fasta` under `root`.
    Returns (assembly path, reads path, the three strains, number of reads,
    read bases)."""
    rng = np.random.default_rng(seed)
    haps = S.make_haplotypes(length, 3, 0.01, rng)
    ab = [1.0, 0.5, rare_cov / base_cov]
    asm_path = os.path.join(root, "asm.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm_path, {"collapsed": haps[0]})
    if use_sim2:
        reads = sim2.generate(haps, coverage=base_cov, seed=seed + 1, abundances=ab)
        sim2.write_fasta(reads_path, reads)
    else:
        reads = S.simulate_reads(
            haps, coverage=base_cov, read_len=8000, rng=rng,
            sub_rate=err * 0.6, ins_rate=err * 0.2, del_rate=err * 0.2,
            abundances=ab, uniform_edges=True,
        )
        S.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, haps, len(reads.seqs), sum(map(len, reads.seqs))


def score_skewed(final: str, haps) -> dict:
    g = parse_gfa(final)
    ev = evaluate_phasing(g.segments, haps)
    return {
        "contigs": len(g.segments),
        "n50": _n50([len(s) for s in g.segments.values()]),
        "recovery": [round(r, 4) for r in ev.haplotype_recovery],
        "rare_recovery": round(ev.haplotype_recovery[-1], 4),
        "switches": ev.total_switch_errors,
    }


def run_scenario(scenario: str, root: str, seed: int = 0, *, device: str = "cuda", n_species: int = 10,
                 length: int = 100_000, rare_cov: float = 5.0, use_sim2: bool = False) -> dict:
    """Builds the scenario's data under `root`, runs the port's pipeline on
    `device` into `root/out` and scores the final assembly. Returns the JSON
    line's fields."""
    import torch

    from hairsplitter_tpu_torch.ops._build import kernel_launch_counts
    from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig, run_pipeline

    if scenario == "metagenome":
        asm_path, reads_path, truth, n_reads, read_bases = build_metagenome(
            root, seed, n_species=n_species, length=length, use_sim2=use_sim2)
    else:
        asm_path, reads_path, truth, n_reads, read_bases = build_skewed(
            root, seed, length=length, rare_cov=rare_cov, use_sim2=use_sim2)
    out = os.path.join(root, "out")
    cuda = torch.device(device).type == "cuda"
    launches0 = kernel_launch_counts()["myers_fused"]
    t0 = time.perf_counter()
    final = run_pipeline(asm_path, reads_path, out, PipelineConfig(device=device))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launch_counts()["myers_fused"] - launches0
    score = score_metagenome(final, truth) if scenario == "metagenome" else score_skewed(final, truth)
    with open(os.path.join(out, "stage_stats.json")) as f:
        stages = {k: v["seconds"] for k, v in json.load(f).items()}
    return {
        "scenario": scenario + ("+sim2" if use_sim2 else ""),
        **score,
        "wall_s": wall,
        "device": str(device),
        "reads": n_reads,
        "read_mbp": read_bases / 1e6,
        "k1_launches": launches,
        "stages": stages,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenario", choices=["metagenome", "skewed"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rare-cov", type=float, default=5.0)
    ap.add_argument("--species", type=int, default=10)
    ap.add_argument("--length", type=int, default=100_000)
    ap.add_argument("--keep", default="", help="keep outputs here")
    ap.add_argument(
        "--sim2", action="store_true",
        help="use the independent read simulator (utils/sim2.py: log-normal "
        "lengths, per-read quality, error bursts, hp run-length noise, junk reads)",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args()

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("torch sees no CUDA device (pass --device cpu to run on the CPU)")
    root = args.keep or tempfile.mkdtemp(prefix=f"hs_eval_{args.scenario}_")
    os.makedirs(root, exist_ok=True)
    try:
        res = run_scenario(args.scenario, root, args.seed, device=args.device, n_species=args.species,
                           length=args.length, rare_cov=args.rare_cov, use_sim2=args.sim2)
        print(json.dumps(res))
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
