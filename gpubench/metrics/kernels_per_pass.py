"""kernels_per_pass: Device kernels per replayed pass, counted in the frame
profiled after the window between its first and last progress
callbacks."""

from gpubench import readers

LAYER = "device"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return readers.kernels_per_pass(ctx)
