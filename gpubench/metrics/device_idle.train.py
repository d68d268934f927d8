"""device_idle.train: 1 - busy / wall over five replayed steps of a job run
after the window under the profiler; the wall leaves out the profiler's
own buffer flushes."""

from gpubench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "step_s"
WORKLOADS = ["cornell.inverse"]


def read(ctx):
    return readers.device_idle(ctx)
