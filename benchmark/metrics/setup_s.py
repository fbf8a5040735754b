"""Seconds from the start of the process to the start of the window: imports,
loading or building the kernels and the native library, generating the
pool and the warm-up job."""


def read(ctx):
    return ctx.setup_s
