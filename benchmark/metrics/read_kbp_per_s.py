"""Read bases of every job completed in the window, in kbp, over the time
from the window's start to the end of its last job: all the work over all
the time."""


def read(ctx):
    if not ctx.jobs:
        return None
    seconds = max(j["end"] for j in ctx.jobs) - ctx.window[0]
    return sum(j["read_bp"] for j in ctx.jobs) / 1e3 / seconds
