"""replay_ms: Device ms per replayed pass: CUDA events recorded after each pass
of every traced frame, from the first pass's to the last's, total time over
total count."""

from gpubench import readers

LAYER = "sample pass"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return readers.replay_ms(ctx)
