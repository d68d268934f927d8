"""device_idle.flagship: 1 - busy / wall over one whole textured mesh
frame rendered after the window under the profiler; busy is the union of
the device operations' intervals, and the wall leaves out the profiler's
own buffer flushes."""

from gpubench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.flagship"]


def read(ctx):
    return readers.device_idle(ctx)
