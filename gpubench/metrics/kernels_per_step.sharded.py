"""kernels_per_step.sharded: Device kernels per replayed sharded step on
rank 0's card, in the frame profiled after the window: the kernels that
started after the frame's first graph launch (the step's pass and its
two all_reduces) over its graph launches."""

LAYER = "device"
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["cornell.sharded4"]


def read(ctx):
    prof = ctx.rec.get("profile")
    if prof is None or not prof.get("replays"):
        return None
    return prof["replay_kernels"] / prof["replays"]
