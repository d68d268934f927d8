"""device_idle.sharded: 1 - busy / wall of rank 0's card over one whole
sharded frame rendered after the window under the profiler; busy is the
union of the device operations' intervals (the collectives' kernels
included), and the wall leaves out the profiler's own buffer flushes."""

from gpubench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.sharded4"]


def read(ctx):
    return readers.device_idle(ctx)
