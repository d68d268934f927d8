"""compact_ms.deep: device ms a pass of the compaction between bounces:
the union of the busy intervals of the kernels launched inside the port's
``crt.compact.order``, ``crt.compact.gather`` and ``crt.compact.scatter``
profiler ranges (the sort of the alive rays, the gather of their state
and pixel ids, the scatter back) in the frame profiled after the window,
over its passes. None where the port opens no such range."""

LAYER = "compaction"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.deep512"]


def read(ctx):
    prof = ctx.rec.get("profile")
    busy = prof.get("compact_busy_s") if prof is not None else None
    return busy * 1e3 / ctx.rec["passes"] if busy is not None else None
