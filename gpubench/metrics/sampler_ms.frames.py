"""sampler_ms.frames: Device ms of every sampler draw (the port's
fine ``crt.sample`` spans, ``SamplerConfig.get_1d`` / ``get_2d``) in the last
replayed pass of the frame profiled after the window: the timing events
each draw recorded into the pass graph."""

from gpubench import span_readers

LAYER = "sample pass"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return span_readers.device_ms(ctx, "crt.sample")
