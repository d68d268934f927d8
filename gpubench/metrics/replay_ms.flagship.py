"""replay_ms.flagship: device ms per replayed pass of the textured mesh
frames: CUDA events recorded after each pass of every traced frame, from
the first pass's to the last's, total time over total count."""

from gpubench import readers

LAYER = "sample pass"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.flagship"]


def read(ctx):
    return readers.replay_ms(ctx)
