"""device_idle.deep: 1 - busy / wall over one whole deep frame (4 eager
compacted passes) rendered after the window under the profiler; busy is
the union of the device operations' intervals, and the wall leaves out
the profiler's own buffer flushes."""

from gpubench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.deep512"]


def read(ctx):
    return readers.device_idle(ctx)
