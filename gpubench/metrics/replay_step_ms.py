"""replay_step_ms: Host ms per replayed step: optimize reads each loss back
before its callback, so the callbacks' times are step ends; total over
count over the window's jobs."""

from gpubench import readers

LAYER = "training"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "step_s"
WORKLOADS = ["cornell.inverse"]


def read(ctx):
    return readers.replay_step_ms(ctx)
