"""Where the time of one training step of the polisher goes, on one GPU.

Steps `train_step` at the shapes of `scripts/torch_train_polisher.py`
(batch 8 x 512 positions x 12 features, Adam at lr 1e-3, cuDNN's
deterministic algorithms as `train_polisher` sets them) on a seeded pool of
64 windows, each batch drawn and uploaded as `train_polisher` does it, and
prints one JSON line per variant:
  * host ms per step over --steps steps, the last one synchronised;
  * device busy ms per step (kernels and copies, torch.profiler over 50
    steps), the device's idle share, device activities per step, and the
    five costliest device items;
and the same with the batch already on the card (no upload) and with cuDNN
left to its default choice of algorithms, to tell the three apart.

Usage (on a machine with a CUDA GPU):
    python scripts/profile_torch_training.py [--steps 400]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import nullcontext

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hairsplitter_tpu_torch  # noqa: F401,E402  (TF32 off before any torch work)
from hairsplitter_tpu_torch.models import polisher as P  # noqa: E402

BATCH, L, POOL = 8, 512, 64


def measure(device, steps: int, upload: bool, deterministic: bool) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    pool = [P._simulate_training_batch(rng, L=L) for _ in range(POOL)]
    pool_x = np.stack([f for f, _ in pool])
    pool_y = np.stack([l for _, l in pool])
    pool_w = (rng.random((POOL, L)) < 0.9).astype(np.float32)
    on_card = [torch.from_numpy(a).to(device) for a in (pool_x, pool_y, pool_w)]
    model = P.PolisherCNN()
    P.init_params(model, torch.Generator().manual_seed(0))
    model.to(device)
    opt = P.make_optimizer(model, 1e-3)

    def step():
        sel = rng.integers(0, POOL, BATCH)
        if upload:
            batch = [torch.from_numpy(a[sel]).to(device) for a in (pool_x, pool_y, pool_w)]
        else:
            idx = torch.from_numpy(sel).to(device)
            batch = [a[idx] for a in on_card]
        return P.train_step(model, opt, *batch)

    with P.deterministic_convolutions() if deterministic else nullcontext():
        for _ in range(20):  # warm-up: cuDNN handles, algorithm choice, allocator
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / steps * 1e3
        n_prof = 50
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                step()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies only: a record_function range (the optimizer's step)
    # shows on the device timeline too, spanning the kernels under it
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.device_time_total for e in on_device)
    by_name: dict[str, float] = {}
    for e in on_device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {
        "upload": upload,
        "deterministic": deterministic,
        "host_ms_per_step": host_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / n_prof,
        "device_idle_share": 1 - busy_us / 1e3 / window_ms,
        "device_activities_per_step": len(on_device) / n_prof,
        "top_device_ms_per_step": {name[:60]: us / 1e3 / n_prof for name, us in top},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_training: needs a CUDA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    for upload, deterministic in ((True, True), (False, True), (True, False), (True, True)):
        print(json.dumps(measure(dev, args.steps, upload, deterministic)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
