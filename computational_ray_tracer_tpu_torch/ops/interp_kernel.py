"""Dense-spectrum interpolation: the CUDA kernel, its wrapper and its plain
PyTorch version.

Port of ``computational_ray_tracer_tpu/ops/pallas_interp.py`` (the
``_interp_kernel`` Pallas TPU kernel, wrapped there by
``dense_interp_pallas``). The kernel source is ``csrc/dense_interp.cu``;
``kernels/build.py`` compiles it with nvcc for ``sm_90a`` at first use.

- :func:`dense_interp_plain` is the plain version:
  ``tables[i0] * (1 - w) + tables[i0 + 1] * w`` with every operation rounded
  on its own and i0 clamped to [0, K-2]. The kernel clamps the same way and
  performs the same float32 operations in the same order, without FMA
  contraction, so the two agree bit for bit on any index.
- :func:`dense_interp` is the wrapper ``spectrum.sample_dense_multi`` calls:
  for CPU tensors it runs the plain version; for CUDA tensors it launches the
  kernel (or raises). ``LAUNCHES`` counts kernel launches.

The TPU kernel's one-hot hi/lo bf16 matrix products are not carried over:
they stand in for a gather, which the card does natively, in float32.
"""

from __future__ import annotations

import torch

from computational_ray_tracer_tpu_torch.ops.mesh_intersect_kernel import (
    check_tensor)

LAUNCHES = 0

# fp32 operations per output element: 1 - w, two products, one sum.
ELEMENT_FLOPS = 4


def dense_interp_plain(tables, i0, w):
    """tables (K, C), i0 (n,), w (n,) -> (n, C): rows lerped as
    tables[i0] * (1 - w) + tables[i0 + 1] * w, i0 clamped to [0, K-2]."""
    i0 = torch.clamp(i0.long(), 0, tables.shape[0] - 2)
    wc = w[:, None]
    return tables[i0] * (1.0 - wc) + tables[i0 + 1] * wc


def _launch(tables, i0, w):
    global LAUNCHES
    from computational_ray_tracer_tpu_torch.kernels import build
    dev = tables.device
    k, c = tables.shape
    n = i0.shape[0]
    check_tensor("tables", tables, (k, c), torch.float32, dev)
    check_tensor("i0", i0, (n,), torch.int32, dev)
    check_tensor("w", w, (n,), torch.float32, dev)
    if k < 2 or c < 1:
        raise ValueError(f"tables has shape {(k, c)}: needs K >= 2, C >= 1")
    if n * c >= 1 << 31:
        raise ValueError(f"{n} x {c} outputs exceed the kernel's 2^31 range")
    lib = build.load_library()
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    err = lib.crt_dense_interp(
        tables.data_ptr(), k, c, i0.data_ptr(), w.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_interp kernel launch failed: CUDA error "
                           f"{err} ({build.error_string(err)})")
    LAUNCHES += 1
    return out


def dense_interp(tables, i0, w):
    """The TPU wrapper's interface: tables (K, C) float32, i0 (n,) int32
    (clamped to [0, K-2]), w (n,) float32 -> (n, C) float32. The caller
    applies any outside-the-range mask.

    CPU tensors run the plain version. CUDA tensors launch the kernel; a
    tensor the kernel does not take (dtype, layout, device) raises."""
    if tables.device.type == "cpu":
        return dense_interp_plain(tables, i0, w)
    if tables.device.type != "cuda":
        raise ValueError(f"dense_interp: unsupported device {tables.device}")
    with torch.no_grad():
        return _launch(tables, i0, w)
