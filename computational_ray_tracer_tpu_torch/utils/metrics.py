"""Timers, structured JSONL metrics and profiler traces
(``computational_ray_tracer_tpu/utils/metrics.py``).

``RenderMeter.pass_done`` synchronises the card before it reads the clock,
so a pass's time is the device's, not the launch queue's; ``trace`` wraps
``torch.profiler`` (CPU and, where there is a card, CUDA activity) and
writes a Chrome trace, the counterpart of the reference's
``jax.profiler`` trace."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch


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


@contextlib.contextmanager
def trace(name, log_dir=None):
    """Profile the block under ``record_function(name)`` and write its
    Chrome trace to ``log_dir/<name>.json``; with ``log_dir=None`` it does
    nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
