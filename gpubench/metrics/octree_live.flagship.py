"""octree_live.flagship: 100 x the rays with t_max > 0 handed to the
octree traversals (the port's ``crt.octree.live.<mode>`` counters) over
every ray handed to them (``crt.octree.lanes.<mode>``), closest and any
hit together, in the eager first pass of the frame profiled after the
window. None where the port counts no such thing."""

from gpubench import span_readers

LAYER = "sample pass"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.flagship"]


def read(ctx):
    rec = span_readers.recorder()
    if rec is None:
        return None
    frame = span_readers.profiled_frame(ctx, rec.spans())
    if frame is None:
        return None
    counts = rec.counters(frame)
    total = lambda kind: sum(v for k, v in counts.items()
                             if k.startswith(f"crt.octree.{kind}."))
    lanes = total("lanes")
    return 100.0 * total("live") / lanes if lanes else None
