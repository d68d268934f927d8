"""rank_skew.sharded: The ranks' load imbalance in the last replayed step
of the frame profiled after the window: each rank's device ms of
``crt.pass`` less its ``crt.collective.sp`` and ``crt.collective.dp``
(what it computes, the waits on the others taken out), and (slowest -
fastest) / slowest over every rank, in %. Each rank reports its own
spans (``rec["ranks"]``, gathered by the job kind)."""

LAYER = "sharding"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.sharded4"]
NAMES = ("crt.pass", "crt.collective.sp", "crt.collective.dp")


def read(ctx):
    ranks = ctx.rec.get("ranks")
    if not ranks or any(set(NAMES) - set(r) for r in ranks):
        return None
    own = [r[NAMES[0]] - r[NAMES[1]] - r[NAMES[2]] for r in ranks]
    slowest = max(own)
    return 100.0 * (slowest - min(own)) / slowest if slowest > 0 else None
