"""Seconds of stage 4, read separation (`pipeline/separate_reads.py`,
`ops/cluster.py`, `ops/phase.py`) per Mbp of reads, as the program records
them in `stage_stats.json` ("separate_reads")."""

from benchmark.metrics._stage import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "separate_reads")
