"""Quickstart demo of the PyTorch port: simulate a 3-strain mix, run the full
pipeline on one GPU, score it. The counterpart of `scripts/demo.py`.

Usage (on a machine with a CUDA GPU; `--device cpu` runs the plain PyTorch
versions on the CPU):
    python scripts/torch_demo.py [--length 60000] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hairsplitter_tpu_torch  # noqa: F401,E402  (TF32 off before any torch work)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--length", type=int, default=60_000, help="genome length")
    ap.add_argument("--strains", type=int, default=3)
    ap.add_argument("--coverage", type=float, default=20.0, help="per strain")
    ap.add_argument("--error", type=float, default=0.10, help="total read error")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="keep outputs here (default: tmp)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args()

    import torch

    from hairsplitter_tpu_torch.io.fasta import write_fasta
    from hairsplitter_tpu_torch.io.gfa import parse_gfa
    from hairsplitter_tpu_torch.ops._build import kernel_launch_counts
    from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig, run_pipeline
    from hairsplitter_tpu_torch.utils import sim as S
    from hairsplitter_tpu_torch.utils.evaluate import evaluate_phasing

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("torch sees no CUDA device (pass --device cpu to run on the CPU)")
    rng = np.random.default_rng(args.seed)
    print(f"simulating {args.strains} strains x {args.length/1e3:.0f} kb at "
          f"{args.coverage:.0f}x each, {args.error:.0%} read error ...")
    haps = S.make_haplotypes(args.length, args.strains, 0.01, rng)
    reads = S.simulate_reads(
        haps, coverage=args.coverage, read_len=8000, rng=rng,
        sub_rate=args.error * 0.6, ins_rate=args.error * 0.2,
        del_rate=args.error * 0.2, uniform_edges=True,
    )
    root = args.out or tempfile.mkdtemp(prefix="hs_demo_")
    os.makedirs(root, exist_ok=True)
    asm = os.path.join(root, "assembly.fasta")
    rd = os.path.join(root, "reads.fasta")
    write_fasta(asm, {"collapsed": haps[0]})  # the collapsed input assembly
    S.write_sim_fasta(rd, reads)
    print(f"{len(reads.seqs)} reads ({sum(len(s) for s in reads.seqs)/1e6:.1f} Mbp) -> {root}")

    launches0 = kernel_launch_counts()["myers_fused"]
    t0 = time.time()
    final = run_pipeline(asm, rd, os.path.join(root, "out"), PipelineConfig(device=args.device))
    wall = time.time() - t0

    g = parse_gfa(final)
    ev = evaluate_phasing(g.segments, haps)
    lens = sorted((len(s) for s in g.segments.values()), reverse=True)
    acc, tot = 0, sum(lens)
    n50 = lens[0] if lens else 0
    for n50 in lens:
        acc += n50
        if acc * 2 >= tot:
            break
    print()
    k1 = kernel_launch_counts()["myers_fused"] - launches0
    print(f"done in {wall:.0f}s on {args.device} ({k1} fused K1 launches) "
          f"-> {final}")
    print(f"  contigs: {len(g.segments)} (N50 {n50/1e3:.0f} kb)")
    for h, r in enumerate(ev.haplotype_recovery):
        print(f"  strain {h}: {r:.1%} of its 31-mers recovered")
    print(f"  switch errors: {ev.total_switch_errors}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
