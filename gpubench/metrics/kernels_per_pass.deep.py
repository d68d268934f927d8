"""kernels_per_pass.deep: device kernels a pass in the deep frame profiled
after the window (4 eager compacted passes and the resolve), every kernel
of the frame over its passes: each eager launch is host time, which sets
the compacted pass's pace."""

LAYER = "device"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.deep512"]


def read(ctx):
    prof = ctx.rec.get("profile")
    return prof["kernels"] / ctx.rec["passes"] if prof is not None else None
