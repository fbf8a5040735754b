"""Seconds of the rescue pass per Mbp of reads: `map_reads` again, with
shorter minimizers, on the reads stage 2 left unmapped ("mapping.rescue")."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "mapping", ("rescue",))
