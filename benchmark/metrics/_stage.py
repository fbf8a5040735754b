"""Shared arithmetic of the stage readers: a stage's seconds as the program
records them (`stage_stats.json`), summed over the traced window's jobs,
per Mbp of their reads."""

from __future__ import annotations


def s_per_mbp(ctx, stage: str) -> float | None:
    jobs = [j for j in ctx.jobs if stage in j["stages"]]
    mbp = sum(j["read_bp"] for j in jobs) / 1e6
    if not jobs or mbp <= 0:
        return None
    return sum(j["stages"][stage] for j in jobs) / mbp
