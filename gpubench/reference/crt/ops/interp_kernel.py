"""Dense-spectrum interpolation: the plain PyTorch version of the CUDA
kernel (``csrc/dense_interp.cu``) and port of
``computational_ray_tracer_tpu/ops/pallas_interp.py``:
``tables[i0] * (1 - w) + tables[i0 + 1] * w`` with every operation rounded
on its own and i0 clamped to [0, K-2]. The kernel clamps the same way and
performs the same float32 operations in the same order, without FMA
contraction, so the two agree bit for bit on any index. Its autograd
carries the table gradient; i0 and w get none (the wavelengths are a
sampling decision, detached as in the reference).
"""

from __future__ import annotations

import torch


def dense_interp(tables, i0, w):
    """tables (K, C) float32, i0 (n,) (clamped to [0, K-2]), w (n,) float32
    -> (n, C) float32: rows lerped as tables[i0] * (1 - w) +
    tables[i0 + 1] * w."""
    i0 = torch.clamp(i0.long(), 0, tables.shape[0] - 2)
    wc = w[:, None]
    return tables[i0] * (1.0 - wc) + tables[i0 + 1] * wc
