"""sync_ms.deep: the host's wait for the alive counts a pass: the port's
coarse ``crt.compact.sync`` spans (one a bounce, around the count read
back) summed within each pass (the eager pass span they open in), the
median over the window's passes, in host ms. None where the port records
no such span, and off the card (no device trace: no device to wait for)."""

import collections
import statistics

from gpubench import span_readers

LAYER = "compaction"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.deep512"]


def read(ctx):
    if ctx.rec.get("profile") is None:
        return None
    per_pass = collections.defaultdict(float)
    for s in span_readers.window_spans(ctx, "crt.compact.sync"):
        per_pass[s["parent"]] += (s["end"] - s["start"]) * 1e3
    return statistics.median(per_pass.values()) if per_pass else None
