"""Seconds of stage 2, mapping (`core/mapping.py`, `core/seeding.py`, the
native library) per Mbp of reads, as the program records them in
`stage_stats.json` ("mapping")."""

from benchmark.metrics._stage import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "mapping")
