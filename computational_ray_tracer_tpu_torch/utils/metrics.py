"""Timers, structured JSONL metrics, profiler traces and the port's span
and counter recorder (``computational_ray_tracer_tpu/utils/metrics.py``).

``RenderMeter.pass_done`` synchronises the card before it reads the clock,
so a pass's time is the device's, not the launch queue's; ``trace`` wraps
``torch.profiler`` (CPU and, where there is a card, CUDA activity) and
writes a Chrome trace, the counterpart of the reference's
``jax.profiler`` trace, with the spans recorded under it beside it.

The recorder keeps spans and counters in memory, in a ring of
``RING_SIZE`` spans that drops its oldest. A span has a name, a start and
an end on the host clock (``time.perf_counter`` seconds), the span open
around it (its parent) and a request id, the id of its root span: every
span of one ``integrator.accumulate`` call shares the call's ``crt.frame``
id, every span of one ``inverse.optimize`` call its ``crt.job`` id.

- :func:`span` (coarse) always records; the program opens a few a frame
  or a training step.
- :func:`fine_span` records only while a ``torch.profiler`` records, and
  is otherwise one flag check. Inside a CUDA-graph capture it also
  records a pair of timing events into the graph, which every replay
  stamps again: read after the replays, the pair gives the span's device
  time in the last replay.
- :func:`count` adds host ints or 0-d device tensors under a name and the
  current request; device values are summed on the device and read back
  only by :func:`counters`.

While a profiler records, every span is also a host range of the
profiler's (a ``cpu_op`` range, which the profiler does not mirror onto
the device's timeline), so the trace and the spans share one clock; the
recorder keeps the offset from its clock to the profiler's (Unix
nanoseconds). The recorder serves one thread: spans nest in the order
they are opened and closed."""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import sys
import time

import torch

# Spans the recorder keeps; the oldest are dropped beyond it.
RING_SIZE = 65536


class Timer:
    """Wall-clock timer: seconds/ms/us/ns since start, and lap."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def seconds(self):
        return time.perf_counter() - self._t0

    def ms(self):
        return self.seconds() * 1e3

    def us(self):
        return self.seconds() * 1e6

    def ns(self):
        return self.seconds() * 1e9

    def lap(self):
        t = self.seconds()
        self.start()
        return t


class MetricsLogger:
    """One JSON object a line: ``{"event": ..., "t": unix time, **fields}``
    appended to ``path``, or printed to ``stream`` (stderr by default)."""

    def __init__(self, stream=None, path=None):
        self._stream = stream or sys.stderr
        self._file = open(path, "a") if path else None

    def log(self, event, **fields):
        line = json.dumps({"event": event, "t": time.time(), **fields})
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            print(line, file=self._stream)

    def close(self):
        if self._file:
            self._file.close()


class RenderMeter:
    """Throughput of a progressive render: one ``pass`` record (index,
    seconds, rays_per_sec) for each pass."""

    def __init__(self, n_pixels, rays_per_sample, logger=None):
        self.n_pixels = n_pixels
        self.rays_per_sample = rays_per_sample
        self.logger = logger or MetricsLogger()
        self.timer = Timer()
        self.passes = 0

    def pass_done(self, block_on=None):
        """Log one pass, timed since the previous one; with ``block_on`` (a
        tensor) its CUDA device is synchronised first."""
        if block_on is not None and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        dt = self.timer.lap()
        self.passes += 1
        rays = self.n_pixels * self.rays_per_sample
        self.logger.log("pass", index=self.passes, seconds=dt,
                        rays_per_sec=rays / max(dt, 1e-9))
        return dt


def clock_offset_ns():
    """Nanoseconds from the recorder's clock (``time.perf_counter_ns``) to
    the clock the profiler stamps host events with (Unix time), read in
    the tightest of five brackets."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


# The profiler's fast host range: a ``cpu_op``, which the profiler does not
# mirror onto the device's timeline as it does a ``record_function``.
_RANGE = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast",
                 None)
_profiling = torch.autograd._profiler_enabled


def recording():
    """Whether a ``torch.profiler`` records (fine spans record only then)."""
    return _profiling()


def capturing():
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class Span:
    """One span: ``name``, ``start`` / ``end`` (host seconds, None while
    open), ``parent`` (id of the span open around it), ``request`` (id of
    its root span), ``attrs``, and ``events``, the timing pair a fine span
    recorded into a graph capture. Open and close it with ``with`` or, for
    a span that crosses a loop's iterations, ``open()`` / ``close()``."""

    __slots__ = ("rec", "id", "name", "root", "fine", "start", "end",
                 "parent", "request", "attrs", "events", "_range")

    def __init__(self, rec, name, root, fine, attrs):
        self.rec, self.name, self.root, self.fine = rec, name, root, fine
        self.attrs = attrs
        self.id = self.start = self.end = self.parent = self.request = None
        self.events = self._range = None

    def open(self):
        rec = self.rec
        rec.last_id += 1
        self.id = rec.last_id
        outer = rec.stack[-1] if rec.stack else None
        if outer is not None:
            self.parent = outer.id
        self.request = self.id if self.root or outer is None \
            else outer.request
        if self.fine and capturing():
            self.events = (torch.cuda.Event(enable_timing=True, external=True),
                           torch.cuda.Event(enable_timing=True, external=True))
            self.events[0].record()
        rec.stack.append(self)
        rec.ring.append(self)
        # Each host stamp is read next to the profiler's range edge: a
        # preemption between the two reads sets them apart by its length.
        if _RANGE is not None and _profiling():
            self._range = _RANGE(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def close(self):
        """Close the span, and any span still open inside it."""
        stack = self.rec.stack
        while stack:
            top = stack.pop()
            if top.events is not None:
                top.events[1].record()
            if top._range is not None:
                top._range.__exit__(None, None, None)
            top.end = time.perf_counter()
            top._range = None
            if top is self:
                break

    __enter__ = open

    def __exit__(self, *exc):
        self.close()

    def device_ms(self):
        """Device ms between the span's pair of events as last stamped (the
        device synced), or None without a pair or a stamp."""
        if self.events is None:
            return None
        try:
            return self.events[0].elapsed_time(self.events[1])
        except RuntimeError:
            return None

    def to_dict(self):
        return {"id": self.id, "name": self.name, "start": self.start,
                "end": self.end, "parent": self.parent,
                "request": self.request, "attrs": dict(self.attrs),
                "device_ms": self.device_ms()}


class Recorder:
    """Spans in a ring of ``size`` (the oldest dropped) and counters by
    (name, request)."""

    def __init__(self, size=RING_SIZE):
        self.ring = collections.deque(maxlen=size)
        self.stack = []
        self.counts = {}
        self.last_id = 0
        self.offset_ns = clock_offset_ns()

    def span(self, name, root=False, **attrs):
        """A coarse span; ``root`` starts a request (a frame, a job)."""
        return Span(self, name, root, False, attrs)

    def fine_span(self, name):
        """A fine span while a profiler records, else a context that does
        nothing."""
        if not _profiling():
            return _NOTHING
        return Span(self, name, False, True, {})

    def count(self, name, value):
        """Add ``value`` (an int or a 0-d tensor, summed where it lives)
        under ``name`` and the innermost open span's request."""
        key = (name, self.stack[-1].request if self.stack else None)
        if isinstance(value, torch.Tensor):
            value = value.detach()
        prev = self.counts.get(key)
        self.counts[key] = value if prev is None else prev + value

    def spans(self):
        """Every span in the ring, oldest first, as dicts: ``id``,
        ``name``, ``start``, ``end``, ``parent``, ``request``, ``attrs``
        and ``device_ms`` (a fine span's device time in the last replay of
        the graph it was captured into; the card is synced first)."""
        if any(s.events is not None for s in self.ring):
            torch.cuda.synchronize()
        return [s.to_dict() for s in self.ring]

    def counters(self, request=None):
        """{name: total} over every request, or over ``request`` alone;
        device values are read back here."""
        out = {}
        for (name, req), value in self.counts.items():
            if request is None or req == request:
                if isinstance(value, torch.Tensor):
                    value = value.item()
                out[name] = out.get(name, 0) + value
        return out

    def reset(self):
        """Drop every closed span and every counter."""
        self.ring.clear()
        self.ring.extend(self.stack)
        self.counts.clear()
        self.offset_ns = clock_offset_ns()


class _Nothing:
    """A fine span while no profiler records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NOTHING = _Nothing()
# The port's recorder: the sites in the program record here.
RECORDER = Recorder()


def span(name, root=False, **attrs):
    """A coarse span of the port's recorder (see :class:`Recorder`)."""
    return RECORDER.span(name, root, **attrs)


def fine_span(name):
    """A fine span of the port's recorder (see :class:`Recorder`)."""
    return RECORDER.fine_span(name)


def count(name, value):
    """Add to a counter of the port's recorder (see :class:`Recorder`)."""
    RECORDER.count(name, value)


def spans():
    """The port's recorder's spans (see :meth:`Recorder.spans`)."""
    return RECORDER.spans()


def counters(request=None):
    """The port's recorder's counters (see :meth:`Recorder.counters`)."""
    return RECORDER.counters(request)


def reset():
    """Clear the port's recorder."""
    RECORDER.reset()


def _trace_base_ns(path):
    """The Chrome trace's ``baseTimeNanoseconds`` (its ``ts`` is Unix us
    less it), 0 where the trace has none."""
    with open(path) as fh:
        found = re.search(r'"baseTimeNanoseconds":\s*(\d+)', fh.read())
    return int(found.group(1)) if found else 0


def _write_spans(path, records, offset_ns, base_ns=0):
    """One JSON line a span of ``records`` (:meth:`Recorder.spans` dicts):
    ``start_us`` / ``end_us`` on the profiler's clock in the units of the
    Chrome trace's ``ts`` (Unix us less ``base_ns``), ``name``, ``id``,
    ``parent``, ``request``, ``attrs``, ``device_ms``."""
    us = lambda t: None if t is None else (
        t * 1e9 + offset_ns - base_ns) * 1e-3
    with open(path, "w") as fh:
        for r in records:
            line = {k: v for k, v in r.items() if k not in ("start", "end")}
            line.update(start_us=us(r["start"]), end_us=us(r["end"]))
            fh.write(json.dumps(line) + "\n")


@contextlib.contextmanager
def trace(name, log_dir=None):
    """Profile the block under ``record_function(name)`` and write its
    Chrome trace to ``log_dir/<name>.json`` and the spans the port
    recorded in it (fine ones included) to ``log_dir/<name>.spans.jsonl``
    (:func:`_write_spans`); with ``log_dir=None`` it does nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = RECORDER.last_id
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    RECORDER.offset_ns = clock_offset_ns()
    chrome = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(chrome)
    _write_spans(os.path.join(log_dir, f"{name}.spans.jsonl"),
                 [s for s in spans() if s["id"] > first], RECORDER.offset_ns,
                 _trace_base_ns(chrome))
