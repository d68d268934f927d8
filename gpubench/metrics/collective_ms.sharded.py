"""collective_ms.sharded: Device ms of the sp and the dp all_reduce (the
port's fine ``crt.collective.sp`` and ``crt.collective.dp`` spans in
``sharding._sharded_sums``) in the last replayed step of rank 0's frame
profiled after the window: the timing events each collective recorded
into the step graph, the wait for the other ranks included."""

from gpubench import span_readers

LAYER = "sharding"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.sharded4"]


def read(ctx):
    sp = span_readers.device_ms(ctx, "crt.collective.sp")
    dp = span_readers.device_ms(ctx, "crt.collective.dp")
    return None if sp is None or dp is None else sp + dp
