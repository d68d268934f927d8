"""alive_share.frames: 100 x the alive rays entering each bounce
(the port's ``crt.bounce.alive`` counter) over the lanes the full wavefront
spent on them (``crt.bounce.lanes``), in the eager first pass of the frame
profiled after the window."""

from gpubench import span_readers

LAYER = "sample pass"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.frames"]


def read(ctx):
    return span_readers.alive_share(ctx)
