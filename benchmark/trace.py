"""What a traced run records, from the benchmark's own files: host-clock
spans around the calls into each layer of the program, the fused mapping
call's inputs and outputs, and the device activity of `torch.profiler`.

The spans wrap the stage functions that `pipeline/orchestrate.py` imports
by name, and `core/mapping.py:fused_call_host`, only for the traced window,
and are taken off again after it. The device trace holds CUDA activities
only (kernels, copies, sets), so the profiler adds no host-side op records.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.metrics._roofline import fused_k1_work

# the names orchestrate.run_pipeline calls, and the stage each belongs to
STAGE_FUNCTIONS = {
    "map_reads": "mapping",
    "prepare_contig_host": "call_variants",
    "finish_preps": "call_variants",
    "call_variants_from_prep": "call_variants",
    "separate_reads_for_contig": "separate_reads",
    "create_new_contigs": "create_new_contigs",
    "unzip": "untangle",
}


@dataclass
class RunContext:
    """What a run recorded, as the metric readers read it (`benchmark/metrics/*.py`)."""
    setup_s: float = 0.0
    jobs: list[dict] = field(default_factory=list)  # completed in the window: {"pool", "read_bp", "start", "end", "stages"}
    readings: dict[int, dict] = field(default_factory=dict)  # pool job -> judged numbers of its first completion
    fused_calls: list[dict] = field(default_factory=list)  # {"seconds", "jobs", "kernel", "bytes", "ops"}
    spans: list[tuple[str, float, float]] = field(default_factory=list)  # (name, host start, host end)
    device_intervals: np.ndarray | None = None  # [n, 2] host-clock seconds, as the trace recorded them
    device_ops: dict[str, float] = field(default_factory=dict)  # name -> device seconds
    window: tuple[float, float] = (0.0, 0.0)
    busy_s: float | None = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_seconds(self, needle: str) -> float:
        return sum(s for name, s in self.device_ops.items() if needle in name)


@contextlib.contextmanager
def layer_spans(ctx: RunContext):
    """Wrap the program's stage functions and its fused call for the
    duration of the block, recording into `ctx`."""
    from hairsplitter_tpu_torch.core import mapping
    from hairsplitter_tpu_torch.pipeline import orchestrate

    saved = []

    def spanned(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                ctx.spans.append((name, t0, time.perf_counter()))
        return wrapper

    def fused_call_host(arrays, spec, kernel, device):
        t0 = time.perf_counter()
        out = fused(arrays, spec, kernel, device)
        seconds = time.perf_counter() - t0
        q, q_lens, t = arrays[0], arrays[1], arrays[2]
        n_bytes, n_ops = fused_k1_work(q_lens, q.shape[1], t.shape[1], out)
        ctx.fused_calls.append(
            {"seconds": seconds, "jobs": int(q.shape[0]), "kernel": kernel, "bytes": n_bytes, "ops": n_ops}
        )
        return out

    for fname, stage in STAGE_FUNCTIONS.items():
        saved.append((orchestrate, fname, getattr(orchestrate, fname)))
        setattr(orchestrate, fname, spanned(stage, getattr(orchestrate, fname)))
    fused = mapping.fused_call_host
    saved.append((mapping, "fused_call_host", fused))
    mapping.fused_call_host = fused_call_host
    try:
        yield ctx
    finally:
        for mod, fname, fn in reversed(saved):
            setattr(mod, fname, fn)


def union_length(intervals: np.ndarray) -> float:
    """Total length covered by [start, end] intervals (overlaps once)."""
    if intervals is None or len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0])]
    total, cur_s, cur_e = 0.0, iv[0, 0], iv[0, 1]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return float(total + cur_e - cur_s)


def idle_gaps(intervals: np.ndarray, window: tuple[float, float]) -> list[tuple[float, float]]:
    """The stretches of the window that no interval covers."""
    lo, hi = window
    if intervals is None or len(intervals) == 0:
        return [(lo, hi)]
    iv = intervals[np.argsort(intervals[:, 0])]
    gaps, at = [], lo
    for s, e in iv:
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def span_at(spans: list[tuple[str, float, float]], t: float) -> str:
    """The innermost span around host time t (the shortest that holds it)."""
    best, best_len = "harness", float("inf")
    for name, s, e in spans:
        if s <= t <= e and e - s < best_len:
            best, best_len = name, e - s
    return best


def read_profile(prof, ctx: RunContext, host_anchor: float) -> None:
    """Device intervals and per-name device seconds from a finished
    `torch.profiler.profile`. The trace's first device activity is the
    anchor launched at host time `host_anchor`; every activity's time is
    put on the host clock from there."""
    import torch

    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        ctx.device_intervals = np.zeros((0, 2))
        ctx.busy_s = 0.0
        return
    iv = np.array([[e.time_range.start, e.time_range.end] for e in evs], dtype=np.float64) / 1e6
    iv = iv - iv[:, 0].min() + host_anchor
    ctx.device_intervals = iv
    lo, hi = ctx.window
    clipped = np.clip(iv, lo, hi)
    ctx.busy_s = union_length(clipped[clipped[:, 1] > clipped[:, 0]])
    ops: dict[str, float] = {}
    for e, (s, t) in zip(evs, iv):
        ops[e.name] = ops.get(e.name, 0.0) + (t - s)
    ctx.device_ops = ops


def breakdown(ctx: RunContext, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the host span they fell in."""
    ops = sorted(ctx.device_ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps(ctx.device_intervals, ctx.window)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name[:120], s] for name, s in ops],
        "idle_gaps": [[span_at(ctx.spans, (s + e) / 2), e - s] for s, e in longest],
    }
