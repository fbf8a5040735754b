"""Where the time goes in the PyTorch port's main path, on one GPU.

Runs the port's CLI on the smoke dataset of `chip_smoke.py` (300 kb x 3
strains, 30x, 10% error, seed 7) three times in one process:
  1. warm-up: wall time and the per-stage table (stage_stats.json);
  2. under torch.profiler (CPU + CUDA): device time by kernel, device busy
     time (device-side events only: kernels, copies, memsets) and the
     device's idle share of the run's wall time;
  3. under cProfile: host functions by cumulative and own time, and the
     fused call's (`run_jobs`) share of `map_reads`.
Prints the tables, and writes them to OUT_DIR/profile.txt when OUT_DIR is given.

Usage (repo root, on a machine with a CUDA GPU):
    python scripts/profile_torch_pipeline.py [OUT_DIR]
"""

from __future__ import annotations

import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _run(cli, asm, reads, out) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["-i", asm, "-f", reads, "-o", out])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"CLI returned {rc}")
    return time.perf_counter() - t0


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_pipeline: needs a CUDA GPU", file=sys.stderr)
        return 1
    from chip_smoke import build_dataset
    from hairsplitter_tpu_torch import cli
    from hairsplitter_tpu_torch.ops import align_myers_cuda as am

    out_dir = sys.argv[1] if len(sys.argv) > 1 else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report: list[str] = [f"card: {card}; torch {torch.__version__}"]

    def emit(line: str = "") -> None:
        print(line, flush=True)
        report.append(line)

    with tempfile.TemporaryDirectory(prefix="hs_prof_") as root:
        asm, reads, _, _ = build_dataset(root)

        am.myers_fused_cuda.launches = 0
        wall = _run(cli, asm, reads, os.path.join(root, "warm"))
        stats = json.load(open(os.path.join(root, "warm", "stage_stats.json")))
        emit(f"warm run: {wall:.3f} s wall, fused Myers launches {am.myers_fused_cuda.launches}")
        for stage, entry in stats.items():
            emit(f"  {stage:20s} {entry['seconds']:8.3f} s")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pwall = _run(cli, asm, reads, os.path.join(root, "prof"))
        # only device-side events: a CPU op's self device time repeats the
        # time of the kernels it launched
        events = [
            e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ]
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy_us = sum(e.self_device_time_total for e in events)
        emit(f"profiled run: {pwall:.3f} s wall; device busy {busy_us / 1e6:.3f} s; "
             f"device idle share {1 - busy_us / 1e6 / pwall:.4f}")
        emit(f"  device activities: {sum(e.count for e in events)} (kernels, copies, memsets)")
        emit("  device time by kernel (ms; launches):")
        for e in events[:25]:
            emit(f"    {e.self_device_time_total / 1e3:10.3f}  {e.count:8d}  {e.key[:90]}")

        cp = cProfile.Profile()
        cp.enable()
        cwall = _run(cli, asm, reads, os.path.join(root, "cprof"))
        cp.disable()
        emit(f"cProfile run: {cwall:.3f} s wall")
        cum = {f[2]: v[3] for f, v in pstats.Stats(cp).stats.items()}
        rj, mr = cum.get("run_jobs", 0.0), cum.get("map_reads", 0.0)
        emit(f"  run_jobs (pack, copies, fused call, host decode) {rj:.3f} s, of which "
             f"myers_fused_cuda {cum.get('myers_fused_cuda', 0.0):.3f} s and expand_rows_host "
             f"{cum.get('expand_rows_host', 0.0):.3f} s, of map_reads {mr:.3f} s "
             f"(share {rj / max(mr, 1e-9):.4f}, cumulative host time)")
        for key in ("cumulative", "tottime"):
            buf = io.StringIO()
            pstats.Stats(cp, stream=buf).sort_stats(key).print_stats(30)
            emit(f"  host functions by {key}:")
            for line in buf.getvalue().splitlines():
                if line.strip() and (line.lstrip()[0].isdigit() or "ncalls" in line):
                    emit("    " + line.rstrip()[:160])

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile.txt"), "w") as f:
            f.write("\n".join(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
