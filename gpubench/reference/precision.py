"""The storage precision of the frozen copy's intermediates.

By default the copy computes and stores in float32, as the port does. The
output check's control runs it under :func:`lowered` with a narrower type:
each value the copy keeps between stages (the camera rays and filter
weights, the path state after each bounce, the radiance, the sensor RGB)
is rounded to that type and back, the step a later change might take to
save bytes. The check has to find that control wrong."""

from __future__ import annotations

import contextlib

import torch

_STORE = [None]


def q(x):
    """``x`` rounded to the storage type in force (float32: unchanged)."""
    dtype = _STORE[0]
    if dtype is None or not torch.is_floating_point(x):
        return x
    return x.to(dtype).to(x.dtype)


@contextlib.contextmanager
def lowered(dtype=torch.bfloat16):
    """Within the block the copy stores its intermediates as ``dtype``."""
    prev = _STORE[0]
    _STORE[0] = dtype
    try:
        yield
    finally:
        _STORE[0] = prev
