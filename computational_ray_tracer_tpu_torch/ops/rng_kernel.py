"""The per-pixel sampler draws: the CUDA kernel, its wrapper and its plain
PyTorch version.

The kernel source is ``csrc/sampler.cu``; ``kernels/build.py`` compiles it
with nvcc for ``sm_90a`` at first use. It replaces no Pallas kernel: the
JAX package draws with jnp operations (``computational_ray_tracer_tpu/ops/
rng.py``), and the plain version here is ``ops/rng.py``, which carries every
32-bit word in an int64 tensor and so spends hundreds of elementwise kernels
on one draw.

- :func:`plain_1d` / :func:`plain_2d` are the plain version: the functions
  of ``ops/rng.py`` for the kinds ``independent``, ``stratified`` and
  ``sobol``, on any device.
- :func:`draw_1d` / :func:`draw_2d` are the wrappers
  ``integrator.SamplerConfig`` calls: for CPU tensors they run the plain
  version; for CUDA tensors they launch the kernel once a draw (or raise),
  bit for bit with the plain version on the card. The sample index and
  the seed are each a Python int or a 0-d int64 tensor on the pixels'
  device, which the kernel reads on the device, so a captured pass reads
  the index each replay steps and the seed the host wrote before the
  replays (:func:`seed_word`). Nothing is read back to the host, and the
  output is allocated with ``torch.empty``, so a draw can be captured in a
  CUDA graph. ``LAUNCHES`` counts the launches.

The ``sobol_global`` kind stays on ``ops/rng.py``: its index solve is
another computation, and no path that is timed runs it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import rng
from computational_ray_tracer_tpu_torch.ops.mesh_intersect_kernel import (
    check_tensor)

LAUNCHES = 0

KINDS = ("independent", "stratified", "sobol")


def plain_1d(kind, seed, pixel, sample_idx, dim, spp, jitter=True):
    """One value a pixel id: ``ops/rng.py``'s 1D draw of ``kind``."""
    if kind == "stratified":
        return rng.stratified_1d(seed, pixel, sample_idx, dim, spp, jitter)
    if kind == "sobol":
        return rng.sobol_owen_1d(seed, pixel, sample_idx, dim, spp=spp)
    if kind == "independent":
        return rng.independent_1d(seed, pixel, sample_idx, dim)
    raise ValueError(f"the sampler kernel has no kind {kind!r}")


def plain_2d(kind, seed, pixel, sample_idx, dim, spp, xs, ys, jitter=True):
    """Two values a pixel id (dims dim and dim + 1): ``ops/rng.py``'s 2D
    draw of ``kind`` (stratified: the xs x ys grid)."""
    if kind == "stratified":
        return rng.stratified_2d(seed, pixel, sample_idx, dim, xs, ys, jitter)
    if kind == "sobol":
        return rng.sobol_owen_2d(seed, pixel, sample_idx, dim, spp=spp)
    if kind == "independent":
        return rng.independent_2d(seed, pixel, sample_idx, dim)
    raise ValueError(f"the sampler kernel has no kind {kind!r}")


class SamplerParams(ctypes.Structure):
    """``CrtSamplerParams`` of ``csrc/sampler.cu``: a draw's uniform
    parameters, passed to the kernel by value."""
    _fields_ = [(name, ctypes.c_uint32) for name in (
        "seed", "dim0", "dim1", "n", "w", "walk", "xs",
        "jitter")] + [("scale0", ctypes.c_float), ("scale1", ctypes.c_float),
                      ("sobol", ctypes.c_uint32 * 64)]


def _reciprocal(x):
    """1 / x rounded to float32, as PyTorch's CUDA division of a float32
    tensor by the Python number x multiplies by it."""
    return float(np.float32(1.0) / np.float32(x))


def draw_params(kind, seed, dim, spp, xs, ys, jitter, two_d):
    """The kernel's SamplerParams of one draw (host arithmetic only)."""
    n = xs * ys if kind == "stratified" and two_d else spp
    if kind == "independent":
        n = 1
    if not 1 <= n <= rng.MASK:
        raise ValueError(f"a permutation of {n} elements: needs 1 <= n < "
                         "2^32")
    w = n - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    d0, d1 = dim & rng.MASK, (dim + 1) & rng.MASK
    p = SamplerParams(
        seed=seed & rng.MASK, dim0=d0, dim1=d1,
        n=n, w=w, walk=w + 1 - n if n & (n - 1) else 0, xs=xs,
        jitter=int(bool(jitter)))
    if kind == "stratified":
        p.scale0 = _reciprocal(xs if two_d else spp)
        p.scale1 = _reciprocal(ys)
    if kind == "sobol":
        cols = rng.SOBOL_MATRICES[[d0 % rng.N_SOBOL_DIMS,
                                   d1 % rng.N_SOBOL_DIMS]]
        p.sobol[:] = [int(v) for v in cols.reshape(-1)]
    return p


def seed_word(seed):
    """What the host writes into a device seed for the int ``seed``: its
    low 32 bits, draw_params' ``seed``, the one word of it any draw reads
    (the kernel takes ``hash_u32`` of it on the card, as of a host seed)."""
    return int(seed) & rng.MASK


def _launch(kind, seed, pixel, sample_idx, dim, spp, xs, ys, jitter, two_d):
    global LAUNCHES
    from computational_ray_tracer_tpu_torch.kernels import build
    if kind not in KINDS:
        raise ValueError(f"the sampler kernel has no kind {kind!r}")
    dev = pixel.device
    check_tensor("pixel", pixel, pixel.shape, torch.int64, dev)
    n = pixel.numel()
    if n >= 1 << 31:
        raise ValueError(f"{n} pixel ids exceed the kernel's 2^31 range")
    if not isinstance(dim, (int, np.integer)):
        raise TypeError(f"the sampler kernel takes a Python int dim, not "
                        f"{type(dim).__name__}")
    if isinstance(sample_idx, torch.Tensor):
        check_tensor("sample_idx", sample_idx, (), torch.int64, dev)
        sample_ptr, sample_host = sample_idx.data_ptr(), 0
    else:
        sample_ptr, sample_host = None, int(sample_idx) & rng.MASK
    if isinstance(seed, torch.Tensor):
        check_tensor("seed", seed, (), torch.int64, dev)
        seed_ptr, seed = seed.data_ptr(), 0
    else:
        seed_ptr = None
    params = draw_params(kind, int(seed), int(dim), int(spp), int(xs),
                         int(ys), bool(jitter), two_d)
    out = torch.empty(tuple(pixel.shape) + ((2,) if two_d else ()),
                      dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = build.load_library().crt_sampler_draw(
        KINDS.index(kind), int(two_d), pixel.data_ptr(), n, sample_ptr,
        sample_host, seed_ptr, ctypes.addressof(params), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sampler kernel launch failed: CUDA error {err} "
                           f"({build.error_string(err)})")
    LAUNCHES += 1
    return out


def _route(pixel, name):
    device = pixel.device if isinstance(pixel, torch.Tensor) else None
    if device is None or device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return "kernel"


def draw_1d(kind, seed, pixel, sample_idx, dim, spp, jitter=True):
    """The 1D draw of ``kind`` for the pixel ids ``pixel`` (int64) at
    ``sample_idx`` in dimension ``dim`` under ``seed`` (an int or a 0-d
    int64 tensor on the pixels' device): float32 of the pixels' shape. CPU
    tensors run :func:`plain_1d`; CUDA tensors launch the kernel, and an
    input it does not take raises."""
    if _route(pixel, "draw_1d") == "plain":
        return plain_1d(kind, seed, pixel, sample_idx, dim, spp, jitter)
    return _launch(kind, seed, pixel, sample_idx, dim, spp, 1, 1, jitter,
                   False)


def draw_2d(kind, seed, pixel, sample_idx, dim, spp, xs, ys, jitter=True):
    """The 2D draw of ``kind`` (dims dim and dim + 1; stratified over the
    xs x ys grid): float32 of the pixels' shape + (2,). CPU tensors run
    :func:`plain_2d`; CUDA tensors launch the kernel, and an input it does
    not take raises."""
    if _route(pixel, "draw_2d") == "plain":
        return plain_2d(kind, seed, pixel, sample_idx, dim, spp, xs, ys,
                        jitter)
    return _launch(kind, seed, pixel, sample_idx, dim, spp, xs, ys, jitter,
                   True)
