"""Reconstruction filters (``computational_ray_tracer_tpu/ops/filters.py``):
box, triangle (tent) and the clipped Gaussian, each sampled exactly through
its inverse CDF. The windowed sinc is not ported yet."""

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


def box_filter(radius=(0.5, 0.5)):
    """Uniform box: weight 2r per axis."""
    def axis(r):
        def s(u):
            return (2.0 * u - 1.0) * r, torch.full_like(u, 2.0 * r)

        def e(x):
            return torch.where(x.abs() <= r, torch.ones_like(x),
                               torch.zeros_like(x))
        return s, e

    rx, ry = radius
    sx, ex = axis(rx)
    sy, ey = axis(ry)
    return Filter("box", tuple(radius), 4.0 * rx * ry, sx, sy, ex, ey)


def triangle_filter(radius=(0.5, 0.5)):
    """Tent filter f(x) = r - |x|, sampled exactly: weight r^2 per axis."""
    def axis(r):
        def s(u):
            return smp.sample_tent(u, r), torch.full_like(u, r * r)

        def e(x):
            return torch.clamp(r - x.abs(), min=0.0)
        return s, e

    rx, ry = radius
    sx, ex = axis(rx)
    sy, ey = axis(ry)
    return Filter("triangle", tuple(radius), rx * rx * ry * ry, sx, sy, ex,
                  ey)


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


FILTERS = {
    "box": box_filter,
    "triangle": triangle_filter,
    "gaussian": gaussian_filter,
}
