"""Seconds of stage 6, untangling (`pipeline/unzip.py`) per Mbp of reads, as
the program records them in `stage_stats.json` ("untangle")."""

from benchmark.metrics._stage import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "untangle")
