"""step_launch_ms.train: Median over the window's replayed steps of the
port's ``crt.step.launch`` span: the host ms of a step graph's replay call."""

from gpubench import span_readers

LAYER = "training"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "step_s"
WORKLOADS = ["cornell.inverse"]


def read(ctx):
    return span_readers.median_ms(ctx, "crt.step.launch")
