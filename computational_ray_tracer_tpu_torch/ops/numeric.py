"""Numeric helpers (``computational_ray_tracer_tpu/ops/numeric.py``):
compensated arithmetic, polynomial evaluation, interval search, Gaussian
and sinc kernels, small least squares and small-table row selects, as
elementwise torch functions over any batch shape. Each keeps its input's
float dtype.

``two_prod`` splits with 2^12 + 1, the float32 Dekker factor of
``shapes._two_prod_err``, so ``prod + err`` is the exact product. (The
reference's ``numeric.two_prod`` splits with 0x10001, which leaves 32-bit
partial products and so is not exact in float32; its ``shapes`` module,
which the watertight test uses, splits with 4097 as here.)
"""

from __future__ import annotations

import math

import torch

# The canonical implementations, re-exported under the reference's names.
from computational_ray_tracer_tpu_torch.ops.shapes import (  # noqa: F401
    MACHINE_EPS, _two_prod_err, difference_of_products, fp_gamma)
from computational_ray_tracer_tpu_torch.ops.sampling import (  # noqa: F401
    erf_inv)


def two_prod(a, b):
    """(a*b, its rounding error) by Dekker splitting: a*b == prod + err in
    exact arithmetic."""
    ab = a * b
    return ab, _two_prod_err(a, b, ab)


def two_sum(a, b):
    """(a+b, its rounding error): Knuth's branch-free TwoSum."""
    s = a + b
    delta = s - a
    return s, (a - (s - delta)) + (b - delta)


def compensated_sum(values, axis=-1, *, dim=None):
    """Kahan-compensated sum along ``axis`` (``dim``: its torch name), in
    the reference's order (one element at a time from the first)."""
    values = torch.movedim(torch.as_tensor(values),
                           axis if dim is None else dim, 0)
    s = torch.zeros_like(values[0])
    c = torch.zeros_like(values[0])
    for i in range(values.shape[0]):
        y = values[i] - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def evaluate_polynomial(t, *coeffs):
    """Horner evaluation of c0 + c1 t + c2 t^2 + ... in float32."""
    t = torch.as_tensor(t, dtype=torch.float32)
    r = torch.zeros_like(t) + torch.tensor(coeffs[-1], dtype=torch.float32)
    for c in reversed(coeffs[:-1]):
        r = r * t + torch.tensor(c, dtype=torch.float32)
    return r


def find_interval(values, x):
    """Largest i with values[i] <= x, clamped to [0, n-2]: the bracketing
    interval of a sorted 1-D table."""
    i = torch.searchsorted(values, x, right=True) - 1
    return torch.clamp(i, 0, values.shape[0] - 2)


def gaussian(x, mu=0.0, sigma=1.0):
    """Normalized Gaussian pdf."""
    inv = 1.0 / (math.sqrt(2.0 * math.pi) * sigma)
    z = (x - mu) / sigma
    return inv * torch.exp(-0.5 * z * z)


def gaussian_integral(x0, x1, mu=0.0, sigma=1.0):
    """Integral of :func:`gaussian` over [x0, x1], through erf."""
    s = sigma * math.sqrt(2.0)
    return 0.5 * (torch.special.erf((x1 - mu) / s)
                  - torch.special.erf((x0 - mu) / s))


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


def linear_least_squares(A, B):
    """X minimizing ||A @ X - B|| for A (n, k), B (n, m), through the
    normal equations in float32 (tiny systems only)."""
    A = torch.as_tensor(A, dtype=torch.float32)
    B = torch.as_tensor(B, dtype=torch.float32)
    return torch.linalg.solve(A.T @ A, A.T @ B)


def select_rows(tab, idx):
    """``tab[idx]`` with ``idx`` clamped to [0, M); callers passing sentinel
    rows must mask the result."""
    m = tab.shape[0]
    return tab[torch.clamp(idx, 0, m - 1)] if m > 0 else tab[idx]
