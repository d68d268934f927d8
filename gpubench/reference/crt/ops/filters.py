"""Reconstruction filters (``computational_ray_tracer_tpu/ops/filters.py``):
the triangle (tent) and the clipped Gaussian, each sampled exactly through
its inverse CDF."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from gpubench.reference.crt.ops import sampling as smp


@dataclasses.dataclass(frozen=True)
class Filter:
    """A separable filter: ``sample(u2) -> (offset (..., 2), weight)`` with
    weight = f(p)/pdf(p)."""
    name: str
    radius: tuple
    _sample_axis_x: Callable
    _sample_axis_y: Callable

    def sample(self, u2):
        px, wx = self._sample_axis_x(u2[..., 0])
        py, wy = self._sample_axis_y(u2[..., 1])
        return torch.stack([px, py], dim=-1), wx * wy


def triangle_filter(radius=(0.5, 0.5)):
    """Tent filter f(x) = r - |x|, sampled exactly: weight r^2 per axis."""
    def axis(r):
        return lambda u: (smp.sample_tent(u, r), torch.full_like(u, r * r))

    return Filter("triangle", tuple(radius), axis(radius[0]),
                  axis(radius[1]))


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

        def s(u):
            up = cdf_l + u * (cdf_r - cdf_l)
            x = torch.clamp(s2 * smp.erf_inv(2.0 * up - 1.0), -r, r)
            pdf = torch.exp(-(x * x) / (2 * sigma * sigma)) / z_trunc
            return x, g(x, r) / torch.clamp(pdf, min=1e-12)
        return s

    return Filter("gaussian", tuple(radius), axis(radius[0]),
                  axis(radius[1]))


FILTERS = {"triangle": triangle_filter, "gaussian": gaussian_filter}
