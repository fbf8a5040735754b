"""Seconds of stage 3, variant calling (`pipeline/call_variants.py`,
`ops/variants.py`, `pipeline/pileup.py`) per Mbp of reads, as the program
records them in `stage_stats.json` ("call_variants")."""

from benchmark.metrics._stage import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "call_variants")
