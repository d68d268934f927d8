"""What the per-layer metrics' readers (``metrics/<metric>.py``) share:
each takes the run's context and returns a number, or None where the run
recorded nothing to read (then the metric is left out of the line)."""

from __future__ import annotations

import statistics


def _traced(ctx):
    """The window's frames with their tracer (the traced run's)."""
    return [f for f in ctx.rec.get("frames", ()) if f["tracer"] is not None]


def first_pass_ms(ctx):
    """Median over the window's traced frames of the host ms from a
    frame's call to its first progress callback (synced): the eager pass
    and the capture."""
    t = [(f["tracer"].t_first - f["t_call"]) * 1e3 for f in _traced(ctx)
         if f["tracer"].t_first is not None]
    return statistics.median(t) if t else None


def replay_ms(ctx):
    """Device ms per replayed pass: CUDA events recorded after every pass,
    from the first pass's to the last's, over the window's traced frames,
    total time over total count."""
    total = count = 0
    for f in _traced(ctx):
        ev = f["tracer"].events
        if len(ev) >= 2:
            total += ev[0].elapsed_time(ev[-1])
            count += len(ev) - 1
    return total / count if count else None


def device_idle(ctx):
    """1 - busy / wall of the profiled span, in %."""
    prof = ctx.rec.get("profile")
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def kernels_per_pass(ctx):
    """Device kernels per replayed pass in the profiled frame."""
    prof = ctx.rec.get("profile")
    if prof is None or not prof.get("kernels_between"):
        return None
    return prof["kernels_between"] / (ctx.rec["passes"] - 1)


def first_steps_ms(ctx):
    """Median over jobs of the host ms from a job's call to its second
    callback: the eager step 0, the capture and the first replay."""
    t = [(j["t_steps"][1] - j["t_call"]) * 1e3
         for j in ctx.rec.get("jobs", ()) if len(j["t_steps"]) >= 2]
    return statistics.median(t) if t else None


def replay_step_ms(ctx):
    """Host ms per replayed step (the callback comes after each loss is
    read back): the time between the callbacks of steps 1 .. last, over
    every job of the window, total over count."""
    total = count = 0
    for j in ctx.rec.get("jobs", ()):
        t = j["t_steps"]
        if len(t) >= 3:
            total += t[-1] - t[1]
            count += len(t) - 2
    return total / count * 1e3 if count else None


def kernels_per_step(ctx):
    """Device kernels per step in the profiled span of steps."""
    prof = ctx.rec.get("profile")
    return prof["kernels"] / prof["steps"] if prof is not None else None
