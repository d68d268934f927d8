"""Device busy and idle time, kernel counts and the breakdown, from a
``torch.profiler`` trace of a span of the window (the traced run only).

Busy is the union of the intervals in which an operation ran on the
device; the span's wall time is taken on the host clock; idle is the rest.
An idle gap is labelled by the innermost host operation or range that was
running at its middle: what kept the device waiting."""

from __future__ import annotations

import bisect
import collections

import torch
from torch.profiler import ProfilerActivity, profile

# Host ranges the generators open around their stages; they label gaps.
# The profiler mirrors each on the device's timeline as an annotation,
# which is no device operation.
RANGE_PREFIX = "gpubench."
# Host events of the profiler itself: the device idles while the host
# flushes the profiler's buffers, which no run without it does. Gaps
# under them are left out of the span's window.
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


def start():
    """A started profiler of host and device activity."""
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


def reduce(prof, wall_s, between=None):
    """The profiled span: {"busy_s", "window_s", "kernels", "ops": {name:
    [seconds, count]}, "gaps": {label: seconds}, "kernels_between"}, where
    ``window_s`` is the span's host wall ``wall_s`` less the idle gaps
    under the profiler's own buffer flushes, and ``kernels_between``
    counts the kernels that started inside the host range named
    ``between`` (None: not counted). Returns None when the trace holds no
    device operation."""
    dev, host = [], []
    for ev in prof.events():
        r = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.name.startswith(RANGE_PREFIX):
                dev.append((r.start, r.end, ev.name))
        else:
            host.append((r.start, r.end, ev.name))
    if not dev:
        return None
    dev.sort()
    busy_us, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    ops = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        ops[name][0] += (e - s) * 1e-6
        ops[name][1] += 1
    kernels_between = None
    if between is not None:
        marks = [(s, e) for s, e, name in host if name == between]
        kernels_between = sum(
            1 for s, _, name in dev if _is_kernel(name)
            and any(ms <= s <= me for ms, me in marks))
    labelled = _label_gaps(gaps, host)
    own = sum(labelled.get(name, 0.0) for name in PROFILER_OWN)
    return {"busy_s": busy_us * 1e-6, "window_s": wall_s - own,
            "kernels": sum(1 for *_, name in dev if _is_kernel(name)),
            "ops": dict(ops), "gaps": labelled,
            "kernels_between": kernels_between}


def _label_gaps(gaps, host):
    """{label: idle seconds}: each gap under the innermost host event that
    covers its middle (the one that started last), or "host, no op"."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = collections.defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = "host, no op"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 5000, -1), -1):
            if host[k][1] >= mid:
                label = host[k][2]
                break
        out[label] += (e - s) * 1e-6
    return dict(out)


def breakdown(reduced):
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host labels under the most idle time."""
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v[0]] for n, v in
                           sorted(reduced["ops"].items(),
                                  key=lambda kv: -kv[1][0])[:10]],
            "idle_gaps": [[n, v] for n, v in top(reduced["gaps"])]}
