"""Of ``computational_ray_tracer_tpu/ops/shapes.py``, what the mesh takes:
the surface record and the exact-product arithmetic of the watertight
triangle test (the analytic shapes are not in the copy)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MACHINE_EPS = float(np.finfo(np.float32).eps) / 2.0


def fp_gamma(n):
    """gamma(n) = n*eps / (1 - n*eps): conservative FP error bound."""
    ne = n * MACHINE_EPS
    return ne / (1.0 - ne)


def _two_prod_err(a, b, ab):
    """Error of the rounded product ab = fl(a*b) by Dekker splitting with
    the float32 split factor 2^12 + 1."""
    split = 4097.0
    a_hi = (a * split) - (a * split - a)
    a_lo = a - a_hi
    b_hi = (b * split) - (b * split - b)
    b_lo = b - b_hi
    return ((a_hi * b_hi - ab) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo


def difference_of_products(a, b, c, d):
    """a*b - c*d with exact-product corrections (symmetric inputs give an
    exact 0, which the watertight triangle test relies on)."""
    ab = a * b
    cd = c * d
    return (ab - cd) + (_two_prod_err(a, b, ab) - _two_prod_err(c, d, cd))


@dataclasses.dataclass
class SurfaceInfo:
    """Per-ray hit record; ``n`` is face-forwarded toward ``wo`` and
    ``backface`` records whether that flip happened."""
    t: torch.Tensor
    valid: torch.Tensor
    p: torch.Tensor
    n: torch.Tensor
    uv: torch.Tensor
    dpdu: torch.Tensor
    dpdv: torch.Tensor
    wo: torch.Tensor
    backface: torch.Tensor


