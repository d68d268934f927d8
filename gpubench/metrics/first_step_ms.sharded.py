"""first_step_ms.sharded: Median over the window's frames (rank 0's
``crt.frame`` spans of ``sharding.render_distributed``) of the frame's
``crt.pass.eager`` plus ``crt.pass.capture`` host ms: the eager first
step, with its collectives, and the capture of the step graph, which
every frame makes anew."""

import statistics

from gpubench import span_readers

LAYER = "sharding"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.sharded4"]


def read(ctx):
    per_frame = {s["request"]: 0.0
                 for s in span_readers.window_spans(ctx, "crt.frame")}
    for name in ("crt.pass.eager", "crt.pass.capture"):
        for s in span_readers.window_spans(ctx, name):
            if s["request"] in per_frame:
                per_frame[s["request"]] += (s["end"] - s["start"]) * 1e3
    return statistics.median(per_frame.values()) if per_frame else None
