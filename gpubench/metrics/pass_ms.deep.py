"""pass_ms.deep: device ms per pass of the deep frames: CUDA events
recorded after each pass of every traced frame, from the first pass's to
the last's, total time over total count. Each pass is an eager compacted
pass, so the interval holds its launches' gaps and its host syncs too."""

from gpubench import readers

LAYER = "sample pass"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.deep512"]


def read(ctx):
    return readers.replay_ms(ctx)
