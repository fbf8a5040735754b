"""Milliseconds of the fused mapping call per thousand chunk jobs: the host
clock around `core/mapping.py:fused_call_host` (pageable copies in and out,
`align_traceback_rows`), summed over the traced window's calls."""


def read(ctx):
    calls = ctx.fused_calls
    jobs = sum(c["jobs"] for c in calls)
    if not jobs:
        return None
    return sum(c["seconds"] for c in calls) * 1e3 / (jobs / 1e3)
