"""Seconds of stage 3's pileup tensorisation per Mbp of reads:
`prepare_contig_host` over the contigs ("call_variants.pileup")."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "call_variants", ("pileup",))
