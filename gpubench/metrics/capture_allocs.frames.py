"""capture_allocs.frames: Median over the window's frames of the device
allocations plus frees (``torch.cuda.memory_stats`` ``num_device_alloc`` and
``num_device_free``) made inside the port's ``crt.pass.capture`` span."""

from gpubench import span_readers

LAYER = "pass capture"
UNIT = "allocations"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames", "canonical.frames"]


def read(ctx):
    return span_readers.capture_allocs(ctx)
