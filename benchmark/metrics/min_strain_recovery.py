"""The lowest share of a truth strain's 31-mers found in the final
assembly, over the pool's jobs, each scored once at its first completion
(`benchmark/reference/score.py`)."""


def read(ctx):
    vals = [r["min_recovery"] for r in ctx.readings.values() if "min_recovery" in r]
    return min(vals) if vals else None
