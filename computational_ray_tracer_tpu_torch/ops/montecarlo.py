"""MIS weights (``computational_ray_tracer_tpu/ops/montecarlo.py``)."""

from __future__ import annotations

import torch


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (beta = 2)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-30)
