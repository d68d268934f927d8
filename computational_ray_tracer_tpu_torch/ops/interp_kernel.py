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
  for CPU tensors it runs the plain version, whose autograd carries the
  table gradient; for CUDA tensors it launches the kernel (or raises)
  through an autograd Function whose backward launches the hand-written
  backward kernel ``crt_dense_interp_backward`` (one launch, the same
  bits in every run) when the table needs a gradient, and nothing
  otherwise. ``LAUNCHES`` counts forward launches, ``LAUNCHES_BACKWARD``
  backward ones; :func:`backward_plan` reports the backward's grid.
- :func:`dense_interp_backward_plain` is the backward's plain version: the
  two ``index_add_`` of the plain forward's autograd. i0 and w get no
  gradient: the wavelengths are a sampling decision, detached as in the
  reference.

The TPU kernel's one-hot hi/lo bf16 matrix products are not carried over:
they stand in for a gather, which the card does natively, in float32.
"""

from __future__ import annotations

import ctypes

import torch

from computational_ray_tracer_tpu_torch.ops.mesh_intersect_kernel import (
    check_tensor)

LAUNCHES = 0
LAUNCHES_BACKWARD = 0

# fp32 operations per output element: 1 - w, two products, one sum.
ELEMENT_FLOPS = 4
# Backward, per gradient element: 1 - w, two products, two sums.
BACKWARD_ELEMENT_FLOPS = 5


def dense_interp_plain(tables, i0, w):
    """tables (K, C), i0 (n,), w (n,) -> (n, C): rows lerped as
    tables[i0] * (1 - w) + tables[i0 + 1] * w, i0 clamped to [0, K-2]."""
    i0 = torch.clamp(i0.long(), 0, tables.shape[0] - 2)
    wc = w[:, None]
    return tables[i0] * (1.0 - wc) + tables[i0 + 1] * wc


def dense_interp_backward_plain(g, i0, w, k):
    """The table gradient (k, C) of :func:`dense_interp_plain` for the
    output gradient g (n, C): (1 - w) g added into row i0 and w g into row
    i0 + 1, i0 clamped to [0, k-2]."""
    i0 = torch.clamp(i0.long(), 0, k - 2)
    wc = w[:, None]
    grad = torch.zeros((k, g.shape[1]), dtype=g.dtype, device=g.device)
    grad.index_add_(0, i0, g * (1.0 - wc))
    grad.index_add_(0, i0 + 1, g * wc)
    return grad


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
    return _DenseInterp.apply(tables, i0, w)


PLAN_FIELDS = ("threads_a_block", "columns_a_tile", "tiles", "rows_a_chunk",
               "rows_a_block", "blocks_a_cluster", "clusters_a_tile",
               "blocks_an_sm", "smem_bytes")


def backward_plan(k, c, n):
    """The backward kernel's launch plan for a (k, c) table and n rows, as
    a dict of PLAN_FIELDS (needs the kernel library, so a card); None if
    the kernel cannot take the shape."""
    from computational_ray_tracer_tpu_torch.kernels import build
    fn = build.load_library().crt_dense_interp_backward_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    if fn(k, c, n, ctypes.cast(out, ctypes.c_void_p)) != 0:
        return None
    return dict(zip(PLAN_FIELDS, out))


def _launch_backward(g, i0, w, k):
    """The backward kernel on the current stream: the (k, C) table
    gradient for the output gradient g (n, C)."""
    global LAUNCHES_BACKWARD
    from computational_ray_tracer_tpu_torch.kernels import build
    dev = g.device
    n, c = g.shape
    check_tensor("g", g, (n, c), torch.float32, dev)
    check_tensor("i0", i0, (n,), torch.int32, dev)
    check_tensor("w", w, (n,), torch.float32, dev)
    if n * c >= 1 << 31:
        raise ValueError(f"{n} x {c} gradients exceed the kernel's 2^31 "
                         "range")
    lib = build.load_library()
    floats = lib.crt_dense_interp_backward_scratch(k, c, n)
    if floats < 0:
        raise ValueError(f"the backward kernel cannot take a table of shape "
                         f"{(k, c)}")
    scratch = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    grad = torch.empty((k, c), dtype=torch.float32, device=dev)
    err = lib.crt_dense_interp_backward(
        g.data_ptr(), k, c, i0.data_ptr(), w.data_ptr(), n, grad.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_interp backward kernel launch failed: "
                           f"CUDA error {err} ({build.error_string(err)})")
    LAUNCHES_BACKWARD += 1
    return grad


def dense_interp_backward(g, i0, w, k):
    """The backward's wrapper: the (k, C) table gradient for the output
    gradient g (n, C). CPU tensors run the plain version; CUDA tensors
    launch the kernel, and a tensor the kernel does not take raises."""
    if g.device.type == "cpu":
        return dense_interp_backward_plain(g, i0, w, k)
    if g.device.type != "cuda":
        raise ValueError(f"dense_interp_backward: unsupported device "
                         f"{g.device}")
    return _launch_backward(g.contiguous(), i0, w, k)


class _DenseInterp(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    table's only; i0 and w are sampling decisions)."""

    @staticmethod
    def forward(ctx, tables, i0, w):
        ctx.save_for_backward(i0, w)
        ctx.k = tables.shape[0]
        return _launch(tables, i0, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        i0, w = ctx.saved_tensors
        return dense_interp_backward(g, i0, w, ctx.k), None, None
