"""What the readers of the port's own spans and counters share: the
recorder of ``computational_ray_tracer_tpu_torch.utils.metrics`` (the
``crt.*`` spans and counters), read after the run. Window metrics take the
spans that started inside the window, ``[rec["t_start"], rec["t_end"]]``
on the same host clock; the profiled frame's metrics take the spans and
counters of the last ``crt.frame`` that started after the window. Each
returns None where nothing was recorded: off the card (no capture), or on
a port that has no recorder."""

from __future__ import annotations

import importlib
import statistics

from gpubench import scenes


def recorder():
    """The port's recorder module, or None where the port has none."""
    try:
        mod = importlib.import_module(f"{scenes.PORT}.utils.metrics")
    except ImportError:
        return None
    return mod if hasattr(mod, "spans") and hasattr(mod, "counters") \
        else None


def window_spans(ctx, name):
    """The closed spans named ``name`` that started inside the window."""
    rec = recorder()
    if rec is None:
        return []
    t0, t1 = ctx.rec["t_start"], ctx.rec["t_end"]
    return [s for s in rec.spans() if s["name"] == name
            and s["end"] is not None and t0 <= s["start"] <= t1]


def median_ms(ctx, name):
    """Median ms of the window's spans named ``name``."""
    ms = [(s["end"] - s["start"]) * 1e3 for s in window_spans(ctx, name)]
    return statistics.median(ms) if ms else None


def capture_allocs(ctx):
    """Median over the window's captures of the device allocations plus
    frees each made (torch's ``empty_cache`` and the graph pool's)."""
    n = [s["attrs"]["device_allocs"] + s["attrs"]["device_frees"]
         for s in window_spans(ctx, "crt.pass.capture")
         if "device_allocs" in s["attrs"]]
    return statistics.median(n) if n else None


def profiled_frame(ctx, spans):
    """The request id of the profiled frame (the last ``crt.frame`` that
    started after the window), or None."""
    frames = [s for s in spans if s["name"] == "crt.frame"
              and s["start"] > ctx.rec["t_end"]]
    return frames[-1]["request"] if frames else None


def device_ms(ctx, name):
    """Device ms of every span named ``name`` captured in the profiled
    frame's pass graph, in its last replay."""
    rec = recorder()
    if rec is None:
        return None
    spans = rec.spans()
    frame = profiled_frame(ctx, spans)
    ms = [s["device_ms"] for s in spans if s["request"] == frame
          and s["name"] == name and s["device_ms"] is not None]
    return sum(ms) if frame is not None and ms else None


def alive_share(ctx):
    """100 x the alive rays entering each bounce over the lanes the full
    wavefront spent on them, in the profiled frame's eager pass."""
    rec = recorder()
    if rec is None:
        return None
    frame = profiled_frame(ctx, rec.spans())
    if frame is None:
        return None
    counts = rec.counters(frame)
    lanes = counts.get("crt.bounce.lanes")
    return 100.0 * counts.get("crt.bounce.alive", 0) / lanes if lanes \
        else None
