"""Samplers (``computational_ray_tracer_tpu/ops/sampling.py``) that the
copy's filters, lens and BSDF take: each a pure function of explicit
uniforms, elementwise over any batch shape.
"""

from __future__ import annotations

import math

import torch

PI_OVER_2 = math.pi / 2.0
PI_OVER_4 = math.pi / 4.0


def erf_inv(x):
    """Inverse error function (polynomial approximation, ~1e-6)."""
    x = torch.clamp(x, -0.99999, 0.99999)
    w = -torch.log((1.0 - x) * (1.0 + x))

    def poly(w, p, cs):
        for c in cs:
            p = p * w + c
        return p

    small = poly(w - 2.5, 2.81022636e-08,
                 (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164,
                  0.246640727, 1.50140941))
    big = poly(torch.sqrt(w) - 3.0, -0.000200214257,
               (0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047,
                1.00167406, 2.83297682))
    return torch.where(w < 5.0, small, big) * x


# ---------------------------------------------------------------------------
# 1-D analytic samplers
# ---------------------------------------------------------------------------


def sample_linear(u, a, b):
    """Inverse-CDF sample of the linear pdf on [0, 1] from a to b."""
    denom = a + torch.sqrt((1.0 - u) * a * a + u * b * b)
    x = u * (a + b) / torch.where(denom == 0.0, torch.ones_like(denom),
                                  denom)
    return torch.clamp(x, max=0.9999999)


def sample_tent(u, r):
    """Tent on [-r, r] as two mirrored linear lobes."""
    u_left = torch.clamp(2.0 * u, 0.0, 1.0)
    u_right = torch.clamp(2.0 * u - 1.0, 0.0, 1.0)
    x_left = -r + r * sample_linear(u_left, 0.0, 1.0)
    x_right = r * sample_linear(u_right, 1.0, 0.0)
    return torch.where(u < 0.5, x_left, x_right)


# ---------------------------------------------------------------------------
# 2-D samplers
# ---------------------------------------------------------------------------


def sample_uniform_disk_concentric(u, radius=1.0):
    """Shirley-Chiu concentric mapping of [0,1)^2 to the disk."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0) & (y == 0)
    one = torch.ones_like(x)
    zx = torch.zeros_like(x)
    xmaj = x.abs() > y.abs()
    ratio = torch.where(
        xmaj, torch.where(x != 0, y / torch.where(x == 0, one, x), zx),
        torch.where(y != 0, x / torch.where(y == 0, one, y), zx))
    r = torch.where(xmaj, x, y)
    theta = torch.where(xmaj, PI_OVER_4 * ratio, PI_OVER_2 - PI_OVER_4 * ratio)
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], torch.zeros_like(p), radius * p)


def sample_cosine_hemisphere(u):
    """Malley's method: the concentric disk lifted to the +z hemisphere."""
    d = sample_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)
