"""step_host_ms.train: Median over the window's replayed steps of the
port's ``crt.step.host`` span: the host ms from a loss read back to the next
step graph's replay launched (the history, the parameters' copies, the
callback and the launch)."""

from gpubench import span_readers

LAYER = "training"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "step_s"
WORKLOADS = ["cornell.inverse"]


def read(ctx):
    return span_readers.median_ms(ctx, "crt.step.host")
