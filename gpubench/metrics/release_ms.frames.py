"""release_ms.frames: Median over the window's frames of the port's
``crt.pass.release`` span: the host ms of freeing a frame's pass graph
(``CUDAGraph.reset``) before ``accumulate`` returns."""

from gpubench import span_readers

LAYER = "pass capture"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return span_readers.median_ms(ctx, "crt.pass.release")
