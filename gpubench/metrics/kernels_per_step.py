"""kernels_per_step: Device kernels per replayed step, counted over five
profiled replayed steps of a job run after the window."""

from gpubench import readers

LAYER = "device"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "step_s"
WORKLOADS = ["cornell.inverse"]


def read(ctx):
    return readers.kernels_per_step(ctx)
