"""Seconds of stage 5's remaps per Mbp of reads: the pinned `map_reads`
of the POA polish (`ops/poa.py:polish_poa_multi`, "create_new_contigs.remap");
0 where no group is polished."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "create_new_contigs", ("remap",))
