"""Seconds of mapping's Python planning and assembly per Mbp of reads:
the job-building loop (`select_pins`, slicing) and the per-plan alignment
assembly and filter of stage 2 ("mapping.plan", "mapping.assemble")."""

from benchmark.metrics._span import s_per_mbp


def read(ctx):
    return s_per_mbp(ctx, "mapping", ("plan", "assemble"))
