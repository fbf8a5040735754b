"""Seconds of stage 3's robust filter per Mbp of reads: the chi2 filter of
`call_variants_from_prep` over the contigs ("call_variants.filter")."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "call_variants", ("filter",))
