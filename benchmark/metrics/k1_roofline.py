"""K1's share of its roofline, in %: the least time the card could take for
the traced window's fused K1 calls (`_roofline.fused_k1_work`, counted from
each call's inputs and outputs) over the device time of `myers_fused_kernel`
in the profiler's trace."""

from benchmark.metrics._roofline import bound_s


def read(ctx):
    calls = [c for c in ctx.fused_calls if c["kernel"] == "myers"]
    device_s = ctx.kernel_seconds("myers_fused_kernel")
    if not calls or not device_s:
        return None
    bound = sum(bound_s(c["bytes"], c["ops"])[0] for c in calls)
    return 100.0 * bound / device_s
