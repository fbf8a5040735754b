"""The share of the traced window in which no operation ran on the device:
1 - (union of the trace's device activity intervals) / (window length)."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s is None:
        return None
    return 1.0 - ctx.busy_s / ctx.window_s
