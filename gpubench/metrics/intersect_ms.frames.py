"""intersect_ms.frames: Device ms of every scene intersection (the
port's fine ``crt.intersect`` spans, ``scene_intersect`` and ``scene_anyhit``:
the kernels and their torch glue) in the last replayed pass of the frame
profiled after the window."""

from gpubench import span_readers

LAYER = "sample pass"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return span_readers.device_ms(ctx, "crt.intersect")
