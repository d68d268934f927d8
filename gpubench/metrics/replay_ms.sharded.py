"""replay_ms.sharded: Device ms of the whole sharded step (the port's fine
``crt.pass`` span around the step ``RenderStepGraph`` captures: the rank's
pass and both all_reduces) in the last replay of rank 0's frame profiled
after the window."""

from gpubench import span_readers

LAYER = "sharding"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.sharded4"]


def read(ctx):
    return span_readers.device_ms(ctx, "crt.pass")
