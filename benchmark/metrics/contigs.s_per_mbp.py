"""Seconds of stage 5, new contigs (`pipeline/new_contigs.py`, `ops/poa.py`,
`ops/triage.py`, `ops/consensus.py`) per Mbp of reads, as the program
records them in `stage_stats.json` ("create_new_contigs")."""

from benchmark.metrics._stage import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "create_new_contigs")
