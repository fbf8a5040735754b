"""Seconds of stage 2's aligning per Mbp of reads: `run_jobs`, which packs
the chunk jobs, makes the fused call and expands its rows on the host
("mapping.align")."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "mapping", ("align",))
