"""The parts of ``computational_ray_tracer_tpu/ops/numeric.py`` the port
uses: the normalized sinc and the Lanczos-windowed sinc (the Lanczos
filter's table). Each keeps its input's float dtype."""

from __future__ import annotations

import math

import torch


def sinc(x):
    """sin(pi x) / (pi x), 1 where |x| < 1e-5."""
    small = x.abs() < 1e-5
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, torch.ones_like(x),
                       torch.sin(math.pi * xs) / (math.pi * xs))


def windowed_sinc(x, radius, tau):
    """sinc(x) sinc(x / tau) inside |x| <= radius, 0 outside."""
    return torch.where(x.abs() > radius, torch.zeros_like(x),
                       sinc(x) * sinc(x / tau))
