"""capture_ms.frames: Median over the window's frames of the port's
``crt.pass.capture`` span: the host ms of ``PassGraph``'s capture, torch's
synchronize, garbage collection and ``empty_cache`` inside
``torch.cuda.graph``, the recording and the instantiation."""

from gpubench import span_readers

LAYER = "pass capture"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return span_readers.median_ms(ctx, "crt.pass.capture")
