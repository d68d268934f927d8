"""octree_ms.flagship: device ms of every octree traversal (the port's
fine ``crt.octree.closest`` and ``crt.octree.anyhit`` spans: the
``octree_live_rays`` and traverse kernels of each launch) in the last
replayed pass of the frame profiled after the window. None where the port
records no such span."""

from gpubench import span_readers

LAYER = "kernels"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.flagship"]

SPANS = ("crt.octree.closest", "crt.octree.anyhit")


def read(ctx):
    ms = [span_readers.device_ms(ctx, name) for name in SPANS]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None
