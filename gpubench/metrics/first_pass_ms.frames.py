"""first_pass_ms.frames: Median host ms from a frame's call to its first
progress callback, synced in the traced run: the eager first pass and the
capture of the pass graph."""

from gpubench import readers

LAYER = "pass capture"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return readers.first_pass_ms(ctx)
