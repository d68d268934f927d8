"""alive_share.deep: 100 x the alive rays entering each bounce (the
port's ``crt.bounce.alive`` counter, which the compacted pass counts as
the full wavefront does) over the lanes a full wavefront would spend on
them (``crt.bounce.lanes``: max_depth x pixels a pass), over the eager
passes of the frame profiled after the window. None where the port
counts no such thing on its compacted route."""

from gpubench import span_readers

LAYER = "sample pass"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.deep512"]


def read(ctx):
    return span_readers.alive_share(ctx)
