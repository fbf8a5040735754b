"""`read_kbp_per_s` of the traced window, per layer, in the cells whose
host-clock rate spreads too widely between runs to hold an end-to-end
bound: read bases of every job completed in the window, in kbp, over the
time from the window's start to the end of its last job."""

from benchmark import manifest


def read(ctx):
    return manifest.reader("read_kbp_per_s")(ctx)
