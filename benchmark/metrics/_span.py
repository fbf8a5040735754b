"""Shared arithmetic of the readers of a stage's span entries in
`stage_stats.json` ("<stage>.<child>": the seconds of the stage's direct
child spans, `hairsplitter_tpu_torch/utils/tracing.py`).

A job holds a stage's span entries when its `stage_stats.json` has the
stage and at least one "<stage>." entry: a program that records no span
inside its stages holds none, and the readers return None. Over the jobs
that hold them, a child missing from one job (a step that did not run
there) counts as 0 seconds.
"""

from __future__ import annotations


def s_per_mbp(ctx, stage: str, children: tuple[str, ...]) -> float | None:
    """Seconds of the entries "<stage>.<child>" per Mbp of reads, over the
    window's jobs that hold the stage's span entries."""
    jobs = [j for j in ctx.jobs
            if stage in j["stages"] and any(k.startswith(stage + ".") for k in j["stages"])]
    mbp = sum(j["read_bp"] for j in jobs) / 1e6
    if not jobs or mbp <= 0:
        return None
    return sum(j["stages"].get(f"{stage}.{c}", 0.0) for j in jobs for c in children) / mbp
