"""Reconstruction filters (``computational_ray_tracer_tpu/ops/filters.py``):
the clipped Gaussian, the only filter of the slice, sampled exactly through
the truncated Gaussian's inverse CDF."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from computational_ray_tracer_tpu_torch.ops import sampling as smp


@dataclasses.dataclass(frozen=True)
class Filter:
    """A separable filter: ``sample(u2) -> (offset (..., 2), weight)`` with
    weight = f(p)/pdf(p); ``evaluate(p)`` gives f(p)."""
    name: str
    radius: tuple
    integral: float
    _sample_axis_x: Callable
    _sample_axis_y: Callable
    _eval_axis_x: Callable
    _eval_axis_y: Callable

    def sample(self, u2):
        px, wx = self._sample_axis_x(u2[..., 0])
        py, wy = self._sample_axis_y(u2[..., 1])
        return torch.stack([px, py], dim=-1), wx * wy

    def evaluate(self, p):
        return self._eval_axis_x(p[..., 0]) * self._eval_axis_y(p[..., 1])


def gaussian_filter(radius=(1.5, 1.5), sigma=0.5):
    """Clipped Gaussian f(x) = g(x) - g(r), sampled by the truncated
    Gaussian via erfinv; the clip offset is folded into the weight."""
    s2 = math.sqrt(2.0) * sigma

    def g(x, r):
        return torch.exp(-(x * x) / (2 * sigma * sigma)) - math.exp(
            -(r * r) / (2 * sigma * sigma))

    def axis(r):
        cdf_r = 0.5 * (1.0 + math.erf(r / s2))
        cdf_l = 1.0 - cdf_r
        z_trunc = (cdf_r - cdf_l) * sigma * math.sqrt(2 * math.pi)
        integral_f = z_trunc - 2.0 * r * math.exp(-(r * r) / (2 * sigma * sigma))

        def s(u):
            up = cdf_l + u * (cdf_r - cdf_l)
            x = torch.clamp(s2 * smp.erf_inv(2.0 * up - 1.0), -r, r)
            pdf = torch.exp(-(x * x) / (2 * sigma * sigma)) / z_trunc
            return x, g(x, r) / torch.clamp(pdf, min=1e-12)

        def e(x):
            v = torch.clamp(g(x, r), min=0.0)
            return torch.where(x.abs() <= r, v, torch.zeros_like(v))
        return s, e, integral_f

    sx, ex, ix = axis(radius[0])
    sy, ey, iy = axis(radius[1])
    return Filter("gaussian", tuple(radius), ix * iy, sx, sy, ex, ey)
