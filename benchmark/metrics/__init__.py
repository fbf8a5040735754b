"""Per-layer metric readers, one file each, named as the metric is in
`BENCHMARK.json`: `read(ctx)` returns the metric's value, or None when the
traced run gave it nothing to read. `ctx` is a `benchmark.trace.RunContext`.
"""
