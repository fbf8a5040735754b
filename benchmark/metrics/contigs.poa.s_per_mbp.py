"""Seconds of stage 5's native POA polish per Mbp of reads: the threaded
native POA batch of `ops/poa.py:polish_poa_multi` ("create_new_contigs.poa");
0 where no group is polished."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "create_new_contigs", ("poa",))
