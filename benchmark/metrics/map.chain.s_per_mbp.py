"""Seconds of seeding and chaining per Mbp of reads: the index build and
the native seeding and chaining of stage 2, with the reads' encoding that
feeds it (`stage_stats.json` "mapping.index", "mapping.chain")."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "mapping", ("index", "chain"))
