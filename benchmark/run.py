"""The benchmark of `hairsplitter_tpu_torch`: whole haplotype-splitting jobs,
back to back, through `pipeline/orchestrate.py:run_pipeline`.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run, from the root of a checkout, on a machine with the GPUs the cell
asks for:

1. Set-up: import the port, load (or, in a fresh checkout, build) its CUDA
   kernels and native library, generate the cell's pool of distinct jobs
   (`traffic/generate.py`) under TMPDIR, and run one warm-up job of the
   cell's own shape, outside the pool. The jobs' content comes from the mix's
   `content_seed`, so that every run does the same work; without one it
   comes from `--seed`.
2. Window: one client in a closed loop submits the pool's jobs in passes,
   each pass in an order drawn from `--seed`, each job a fresh
   `run_pipeline` into a fresh directory, read and deleted once the job
   returns. The window completes one pass over the pool, then starts no
   job after `--seconds`; the job in flight finishes and counts. With
   `--trace 1` the window runs under `torch.profiler` (CUDA activities)
   with the harness's spans around each layer (`trace.py`).
3. Check: every distinct output of the window is judged against the truth
   and the plain references (`reference/judge.py`), stage 2 on a sample
   of reads drawn from `--seed`, and held to the cell's limits
   (`limits/<cell>.json`).
4. The last line of standard output is one JSON object: `correct`,
   `attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
   `breakdown`, and last `checks`, each number compared beside its limit;
   the same comparisons are the last lines of standard error.

Without a CUDA device, with fewer devices than the cell asks for, without
the port beside this folder, or with JAX or the JAX package loaded once
the window closes, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import manifest  # noqa: E402
from benchmark.reference import judge as J  # noqa: E402
from benchmark.trace import RunContext, breakdown, layer_spans, read_profile  # noqa: E402
from benchmark.traffic import generate  # noqa: E402

BANNED_MODULES = ("jax", "jaxlib", "flax", "optax", "hairsplitter_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def _rng_seed(seed: int, *stream: int) -> list[int]:
    return [seed % (1 << 63), *stream]


def banned_loaded(modules=None) -> list[str]:
    """Top-level names, compared whole, of the loaded modules (or of
    `modules`) that the measuring process may not hold."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(BANNED_MODULES))


def pipeline_config(cell: manifest.Cell, device: str):
    from hairsplitter_tpu_torch.pipeline.orchestrate import PipelineConfig

    return PipelineConfig(device=device, **cell.config["pipeline"])


def load_program(device: str) -> None:
    """Import the port and load its native library and, on a GPU, its
    kernels (built into the checkout's `hairsplitter_tpu_torch/build/` at
    a checkout's first run)."""
    import hairsplitter_tpu_torch  # noqa: F401  (TF32 off before any torch work)
    from hairsplitter_tpu_torch import native
    from hairsplitter_tpu_torch.ops import _build

    if native.get_lib() is None:
        raise RuntimeError("the port's native library did not build or load")
    if device.startswith("cuda"):
        _build.load_kernels()


def run_job(job: generate.Job, out_dir: str, cfg) -> tuple[dict[str, str], dict]:
    """One `run_pipeline` of a job into `out_dir`; returns the texts of the
    judged artifacts and the stage seconds, and deletes the directory."""
    from hairsplitter_tpu_torch.pipeline import orchestrate

    try:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            orchestrate.run_pipeline(job.paths["assembly"], job.paths["reads"], out_dir, cfg)
        files = {}
        for key, rel in J.ARTIFACTS.items():
            with open(os.path.join(out_dir, rel)) as f:
                files[key] = f.read()
        with open(os.path.join(out_dir, "stage_stats.json")) as f:
            stages = {k: v["seconds"] for k, v in json.load(f).items()}
        return files, stages
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def digest(files: dict[str, str]) -> str:
    h = hashlib.sha256()
    for key in sorted(files):
        h.update(key.encode() + b"\0" + files[key].encode() + b"\0")
    return h.hexdigest()


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float = T_PROCESS) -> dict:
    """Set-up, window and check of one run; returns the result line's
    object (`checks` last). `device` is "cuda" on the card; the benchmark's
    own tests pass "cpu" to drive the rest of a run without one."""
    import torch

    ctx = RunContext()
    load_program(device)
    cfg = pipeline_config(cell, device)
    work = tempfile.mkdtemp(prefix="hsbench-")  # under TMPDIR
    try:
        pool_size = int(cell.params.get("pool", 3))
        content = cell.params.get("content_seed")
        content = seed if content is None else int(content)
        pool = [generate.make_job(cell.params, _rng_seed(content, 0, j)) for j in range(pool_size)]
        for j, job in enumerate(pool):
            generate.write_job(job, os.path.join(work, f"job{j}"))
        truths = [J.truth_of(job, np.random.default_rng(_rng_seed(seed, 2, j))) for j, job in enumerate(pool)]
        order = np.random.default_rng(_rng_seed(seed, 3))
        warm = generate.make_job(cell.params, _rng_seed(content, 1))
        generate.write_job(warm, os.path.join(work, "warmup"))
        run_job(warm, os.path.join(work, "warmup_out"), cfg)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        ctx.setup_s = time.perf_counter() - t_process

        outputs: dict[str, tuple[int, dict]] = {}  # digest -> (pool job, artifacts)
        first: dict[int, str] = {}
        attempted = failed = 0
        prof = None
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CUDA] if device.startswith("cuda") else [ProfilerActivity.CPU]
                prof = stack.enter_context(profile(activities=acts))
                stack.enter_context(layer_spans(ctx))
            if trace and device.startswith("cuda"):
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if trace and device.startswith("cuda"):
                torch.ones(1, device=device).add_(1)  # the trace's first device activity: its anchor
            queue: list[int] = []
            while attempted < pool_size or time.perf_counter() - t0 < seconds:
                if not queue:
                    queue = order.permutation(pool_size).tolist()
                j = queue.pop(0)
                attempted += 1
                t_job = time.perf_counter()
                try:
                    files, stages = run_job(pool[j], os.path.join(work, f"out{attempted}"), cfg)
                except Exception:  # a failed job is counted and reported; the loop goes on
                    failed += 1
                    traceback.print_exc(file=sys.stderr)
                    continue
                finally:
                    ctx.spans.append(("run_pipeline", t_job, time.perf_counter()))
                ctx.jobs.append({"pool": j, "read_bp": pool[j].reads.bases, "start": t_job,
                                 "end": time.perf_counter(), "stages": stages})
                d = digest(files)
                outputs.setdefault(d, (j, files))
                first.setdefault(j, d)
            if device.startswith("cuda"):
                torch.cuda.synchronize()
            ctx.window = (t0, time.perf_counter())
        if device.startswith("cuda"):
            memory_peak = int(torch.cuda.max_memory_allocated())
        else:
            memory_peak = 0
        if prof is not None:
            read_profile(prof, ctx, t0)
        found = banned_loaded()
        if found:
            raise BannedModules(found)
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()

        # the check: every distinct output against the references
        J.reference_costs(truths, device)
        readings = {d: J.judge(truths[j], files) for d, (j, files) in outputs.items()}
        ctx.readings = {j: readings[d] for j, d in first.items()}
        numbers = J.worst(list(readings.values()))
        ok, rows = J.verdict(numbers, cell.limits)
        correct = ok and failed == 0 and len(first) == pool_size

        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
               "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
               "count": cell.chips, "memory_peak_bytes": memory_peak}
        result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
                  "device": dev}
        if trace:
            dev["busy_s"] = float(ctx.busy_s or 0.0)
            dev["window_s"] = float(ctx.window_s)
            result["breakdown"] = breakdown(ctx)
        result["jobs"] = [[j["pool"], j["end"] - j["start"]] for j in ctx.jobs]  # seconds of each job
        result["numbers"] = numbers  # every judged number, compared or not
        result["checks"] = {name: {"value": value, "limit": lim} for name, value, lim in rows}
        result["checks"]["jobs_failed"] = {"value": failed, "limit": 0}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


class BannedModules(RuntimeError):
    def __init__(self, found: list[str]):
        super().__init__("loaded in the measuring process: " + ", ".join(found))
        self.found = found


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHE_DIRS.items():  # kernel caches at fixed paths inside the checkout
        os.environ[var] = os.path.join(manifest.ROOT, ".cache", sub)
    try:
        cell = manifest.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    except BannedModules as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 4
    except ImportError as exc:
        print(f"benchmark: the port did not import: {exc}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
