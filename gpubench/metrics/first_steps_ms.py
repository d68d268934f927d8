"""first_steps_ms: Median over the window's jobs of the host ms from a job's
call to its second callback: the eager step 0, the capture of the step graph
and the first replay."""

from gpubench import readers

LAYER = "training"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "step_s"
WORKLOADS = ["cornell.inverse"]


def read(ctx):
    return readers.first_steps_ms(ctx)
