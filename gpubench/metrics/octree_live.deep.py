"""octree_live.deep: 100 x the rays with t_max > 0 handed to the octree
traversals over every ray handed to them (the port's
``crt.octree.live.<mode>`` / ``crt.octree.lanes.<mode>`` counters, closest
and any hit together), over the four eager compacted passes of the frame
profiled after the window: ``octree_live.flagship``'s reading. None where
the port counts no such thing."""

from gpubench import cells

LAYER = "sample pass"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.deep512"]


def read(ctx):
    return cells.metric("octree_live.flagship").read(ctx)
