"""Seconds of stage 3's batched window statistics per Mbp of reads:
`finish_preps`, one device pass over every contig's windows
("call_variants.stats")."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "call_variants", ("stats",))
