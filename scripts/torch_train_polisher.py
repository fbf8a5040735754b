"""Train the NN polisher of the PyTorch port (`-p medaka`) on realistic
indel-rich pileups, mapped through the port's mapper on one GPU, and write
the weights to a file of your choosing: the counterpart of
`scripts/train_polisher.py`.

The file has the flax layout of the shipped weights (`save_weights`), so
either package loads it. The shipped `models/polisher_weights.npz` of either
package is never written: `--out` is required and may not name it.

Prints the training's size and seconds, the corpus seconds and its fused K1
launches, ms per training step, then the held-out check of
`train_polisher.py` (6 realistic pairs of `default_rng(1234)` at L = 2048:
the net's column accuracy against plain majority), and last one JSON line
with the same numbers.

Usage (on a machine with a CUDA GPU; `--device cpu` trains on the CPU):
    python scripts/torch_train_polisher.py --out /tmp/w.npz [--steps 800] [--pairs 48] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import hairsplitter_tpu_torch  # noqa: F401,E402  (TF32 off before any torch work)
from hairsplitter_tpu_torch.models import polisher as P  # noqa: E402

# the weights shipped with each package, never written by this script
SHIPPED = (P.WEIGHTS_PATH, os.path.join(REPO, "hairsplitter_tpu", "models", "polisher_weights.npz"))
HELD_OUT_SEED, HELD_OUT_PAIRS, HELD_OUT_L = 1234, 6, 2048


def is_shipped(path: str) -> bool:
    real = os.path.realpath(path)
    return any(real == os.path.realpath(p) for p in SHIPPED)


def held_out_accuracy(nn: P.NNPolisher, device) -> tuple[float, float]:
    """`train_polisher.py`'s check: per-column accuracy of the net and of
    plain majority over the covered columns of 6 held-out realistic pairs."""
    rng = np.random.default_rng(HELD_OUT_SEED)
    n_nn = n_maj = n_tot = 0
    for _ in range(HELD_OUT_PAIRS):
        feats, labels, w = P._realistic_training_pair(rng, L=HELD_OUT_L, device=device)
        mask = w > 0
        maj = feats[:, :5].argmax(axis=1)
        pred = nn.logits(feats).argmax(axis=1)
        n_nn += int((pred[mask] == labels[mask]).sum())
        n_maj += int((maj[mask] == labels[mask]).sum())
        n_tot += int(mask.sum())
    return n_nn / n_tot, n_maj / n_tot


def train_and_check(out: str, steps: int = 800, pairs: int = 48, seed: int = 0, *, device) -> dict:
    """Trains at `train_polisher.py`'s settings (realistic pairs, batch 8,
    L = 512, lr 1e-3), writes the weights to `out` and runs the held-out
    check. Returns the numbers the script prints."""
    import torch

    from hairsplitter_tpu_torch.ops._build import kernel_launch_counts

    if is_shipped(out):
        raise ValueError(f"{out} is a shipped weights file; write the trained weights elsewhere")
    timings: dict = {}
    launches0 = kernel_launch_counts()["myers_fused"]
    t0 = time.perf_counter()
    nn = P.train_polisher(seed=seed, steps=steps, realistic=True, n_pairs=pairs, device=device, timings=timings)
    train_wall = time.perf_counter() - t0
    corpus_launches = kernel_launch_counts()["myers_fused"] - launches0
    P.save_weights(nn, out)
    launches1 = kernel_launch_counts()["myers_fused"]
    t1 = time.perf_counter()
    acc_nn, acc_maj = held_out_accuracy(nn, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {
        "out": out,
        "device": str(device),
        "steps": steps,
        "pairs": pairs,
        "seed": seed,
        "training_s": train_wall,
        "corpus_s": timings["corpus_seconds"],
        "corpus_k1_launches": corpus_launches,
        "steps_s": timings["train_seconds"],
        "ms_per_step": timings["train_seconds"] / max(steps, 1) * 1e3,
        "held_out_accuracy": acc_nn,
        "held_out_majority": acc_maj,
        "held_out_s": time.perf_counter() - t1,
        "held_out_k1_launches": kernel_launch_counts()["myers_fused"] - launches1,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--pairs", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="weights file to write (not the shipped one)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu trains on the CPU)")
    args = ap.parse_args()

    import torch

    if is_shipped(args.out):
        ap.error(f"--out {args.out} is the shipped weights file; give another path")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("torch sees no CUDA device (pass --device cpu to train on the CPU)")
    res = train_and_check(args.out, args.steps, args.pairs, args.seed, device=args.device)
    print(f"trained {res['steps']} steps on {res['pairs']} realistic pairs on {res['device']} in "
          f"{res['training_s']:.1f}s -> {res['out']}")
    print(f"corpus {res['corpus_s']:.3f}s ({res['corpus_k1_launches']} fused K1 launches); "
          f"{res['ms_per_step']:.3f} ms per training step")
    print(f"held-out column accuracy: nn {res['held_out_accuracy']:.5f} vs majority {res['held_out_majority']:.5f}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
