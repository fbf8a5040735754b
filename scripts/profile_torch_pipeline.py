"""Where a job's time goes, by the port's own spans, on one GPU: the
per-stage budget of host, device and transfer time.

Runs jobs of one benchmark cell (`benchmark/manifest.py`, its pool from
`benchmark/traffic/generate.py`, the cell's pipeline flags) through
`run_pipeline`: one warm-up job, then each job of the pool under
`torch.profiler` with CUDA activities only. `benchmark/trace.py:read_profile`
puts the device activities on the host's `perf_counter` clock through an
anchor launched at the job's start, and they are laid over the job's
spans (`hairsplitter_tpu_torch/utils/tracing.py`). Prints, for the pool's
jobs together:

  1. each span, by its path from the job down (calls summed): wall, self
     time (wall less what its child spans cover), device-busy time (the
     union of device activities inside it), memcpy time and the device's
     idle share of its wall time;
  2. the ten longest device-idle gaps, each split over the innermost spans
     it covers;
  3. the recorder's cost: microseconds per span in a tight loop, spans per
     job, and their product as a share of a job.

Writes the same text to OUT_DIR/<cell>.txt and one JSON line of the
numbers to OUT_DIR/<cell>.json when --out is given.

Usage (repo root, on a machine with a CUDA GPU):
    python scripts/profile_torch_pipeline.py --workload strains-ont.clonal30x [--seed N] [--out DIR]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import trace  # noqa: E402

MEMCPY = ("memcpy", "Memcpy")


def covered(iv: np.ndarray, s: float, e: float) -> float:
    """Length of [s, e] that the [start, end] intervals iv cover."""
    if len(iv) == 0 or e <= s:
        return 0.0
    clipped = np.clip(iv, s, e)
    return trace.union_length(clipped[clipped[:, 1] > clipped[:, 0]])


def paths_of(spans) -> dict:
    """span id -> its path from the job down ("job/mapping/align")."""
    by_id = {s.id: s for s in spans}
    out = {}

    def path(s):
        if s.id not in out:
            up = by_id.get(s.parent)
            out[s.id] = s.name if up is None else path(up) + "/" + s.name
        return out[s.id]

    for s in spans:
        path(s)
    return out


def span_table(spans, busy: np.ndarray, copies: np.ndarray) -> dict:
    """path -> [calls, wall, self, device, memcpy], summed over calls; busy
    and copies are the device's intervals on the host clock."""
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    paths = paths_of(spans)
    table: dict[str, list] = {}
    for s in spans:
        inner = np.array([[c.start, c.end] for c in kids[s.id]]).reshape(-1, 2)
        own = s.seconds - covered(inner, s.start, s.end)
        row = table.setdefault(paths[s.id], [0, 0.0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += s.seconds
        row[2] += own
        row[3] += covered(busy, s.start, s.end)
        row[4] += covered(copies, s.start, s.end)
    return table


def split_gap(spans, paths, s: float, e: float) -> dict:
    """The gap [s, e] split over the innermost span at each moment."""
    inside = [sp for sp in spans if sp.start < e and sp.end > s]
    cuts = sorted({s, e, *[t for sp in inside for t in (sp.start, sp.end) if s < t < e]})
    out: dict[str, float] = collections.defaultdict(float)
    for a, b in zip(cuts[:-1], cuts[1:]):
        mid = (a + b) / 2
        holding = [sp for sp in inside if sp.start <= mid <= sp.end]
        name = paths[min(holding, key=lambda sp: sp.seconds).id] if holding else "(no span)"
        out[name] += b - a
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_cost_us(n: int = 200_000) -> float:
    """Microseconds per open-and-close of a span with one count, under an
    open parent, in a tight loop."""
    from hairsplitter_tpu_torch.utils import tracing

    with tracing.span("cost"):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("x", n=1):
                pass
        return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="strains-ont.clonal30x")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_pipeline: needs a CUDA GPU", file=sys.stderr)
        return 1
    from benchmark import manifest, run
    from benchmark.traffic import generate
    from hairsplitter_tpu_torch.pipeline import orchestrate
    from hairsplitter_tpu_torch.utils import tracing

    cell = manifest.load_cell(args.workload)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report: list[str] = [f"{cell.name}; card: {card}; torch {torch.__version__}"]

    def emit(line: str = "") -> None:
        print(line, flush=True)
        report.append(line)

    run.load_program("cuda")
    cfg = run.pipeline_config(cell, "cuda")
    content = cell.params.get("content_seed")
    content = args.seed if content is None else int(content)
    work = tempfile.mkdtemp(prefix="hs_budget_")
    try:
        pool = [generate.make_job(cell.params, run._rng_seed(content, 0, j))
                for j in range(int(cell.params.get("pool", 3)))]
        warm = generate.make_job(cell.params, run._rng_seed(content, 1))
        for name, job in [("warmup", warm)] + [(f"job{j}", job) for j, job in enumerate(pool)]:
            generate.write_job(job, os.path.join(work, name))
        run.run_job(warm, os.path.join(work, "warmup_out"), cfg)

        all_spans, rows, gaps = [], {}, []
        job_walls, read_bp = [], 0
        for j, job in enumerate(pool):
            out = os.path.join(work, f"out{j}")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.ones(1, device="cuda").add_(1)  # the trace's first device activity: its anchor
                orchestrate.run_pipeline(job.paths["assembly"], job.paths["reads"], out, cfg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            shutil.rmtree(out, ignore_errors=True)
            job_span = [s for s in tracing.spans() if s.name == "job"][-1]
            ctx = trace.RunContext(window=(job_span.start, job_span.end))
            trace.read_profile(prof, ctx, t0)
            busy = ctx.device_intervals
            # read_profile keeps the trace's CUDA activities in their order
            is_copy = np.array([any(m in e.name for m in MEMCPY) for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA], dtype=bool)
            copies = busy[is_copy]
            spans = [s for s in tracing.spans() if s.job == job_span.id]
            all_spans.append(len(spans))
            job_walls.append(t1 - t0)
            read_bp += job.reads.bases
            for path, row in span_table(spans, busy, copies).items():
                acc = rows.setdefault(path, [0, 0.0, 0.0, 0.0, 0.0])
                for k in range(5):
                    acc[k] += row[k]
            paths = paths_of(spans)
            for s, e in trace.idle_gaps(busy, ctx.window):
                gaps.append((e - s, j, s - t0, split_gap(spans, paths, s, e)))

        wall = sum(job_walls)
        emit(f"{len(pool)} jobs, {read_bp / 1e6:.3f} Mbp of reads, {wall:.3f} s from anchor to "
             f"synchronise ({', '.join(f'{w:.3f}' for w in job_walls)}); seconds summed over the jobs")
        emit(f"{'span':48s} {'calls':>6s} {'wall s':>9s} {'self s':>9s} {'device s':>9s} "
             f"{'memcpy s':>9s} {'idle':>7s} {'s/Mbp':>8s}")
        for path in sorted(rows, key=lambda p: _order(p, rows)):
            calls, w, own, dev, cp = rows[path]
            depth = path.count("/")
            name = "  " * depth + path.rsplit("/", 1)[-1]
            emit(f"{name:48s} {calls:6d} {w:9.4f} {own:9.4f} {dev:9.4f} {cp:9.4f} "
                 f"{1 - dev / w if w > 0 else 0:7.4f} {w / (read_bp / 1e6):8.4f}")
        emit()
        emit("ten longest device-idle gaps, split over the innermost spans they cover:")
        for length, j, at, split in sorted(gaps, key=lambda g: -g[0])[:10]:
            parts = ", ".join(f"{p} {s:.3f}" for p, s in list(split.items())[:6])
            emit(f"  {length:.3f} s (job {j}, +{at:.3f} s): {parts}")
        cost = span_cost_us()
        per_job = float(np.mean(all_spans))
        share = cost * 1e-6 * per_job / (wall / len(pool))
        emit()
        emit(f"recorder: {cost:.3f} us a span in a tight loop; {per_job:.1f} spans a job "
             f"({', '.join(map(str, all_spans))}); {share * 100:.5f}% of a job")
        summary = {"cell": cell.name, "card": card, "jobs": len(pool), "read_bp": read_bp, "wall_s": wall,
                   "job_s": job_walls, "spans_per_job": all_spans, "span_us": cost, "recorder_share": share,
                   "spans": {p: dict(zip(("calls", "wall", "self", "device", "memcpy"), r))
                             for p, r in rows.items()},
                   "idle_gaps": [[g[0], g[1], g[2], g[3]] for g in sorted(gaps, key=lambda g: -g[0])[:10]]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{cell.name}.txt"), "w") as f:
            f.write("\n".join(report) + "\n")
        with open(os.path.join(args.out, f"{cell.name}.json"), "w") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


def _order(path: str, rows: dict) -> tuple:
    """Depth-first, children by wall time, longest first."""
    parts = path.split("/")
    return tuple(x for i in range(1, len(parts) + 1)
                 for x in (-rows.get("/".join(parts[:i]), [0, 0.0])[1], parts[i - 1]))


if __name__ == "__main__":
    sys.exit(main())
