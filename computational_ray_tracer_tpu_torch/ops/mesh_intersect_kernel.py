"""Brute-force mesh closest hit: the CUDA kernel, its wrapper and its plain
PyTorch version.

Port of ``computational_ray_tracer_tpu/ops/pallas_intersect.py`` (the
``_intersect_kernel`` Pallas TPU kernel) and of the jnp
``triangle.mesh_intersect_brute`` it mirrors. The kernel source is
``csrc/mesh_intersect.cu``; ``kernels/build.py`` compiles it with nvcc for
``sm_90a`` at first use.

- :func:`mesh_intersect_plain` is the plain version: the watertight test in
  triangle-major layout over chunks of rays, with the float32 Dekker split
  of ``ops/shapes.py``. The CUDA kernel performs the same float32 operations
  in the same order, without FMA contraction, so the two agree bit for bit.
- :func:`mesh_intersect` is the wrapper the scene calls: for CPU tensors it
  runs the plain version; for CUDA tensors it launches the kernel (or
  raises). ``LAUNCHES`` counts kernel launches.

Outputs are detached (hit ids and barycentrics are sampling decisions; the
reference gives them zero tangents).
"""

from __future__ import annotations

import math

import torch

from computational_ray_tracer_tpu_torch.ops.shapes import (
    difference_of_products, fp_gamma)

LAUNCHES = 0

# fp32 operations (add, sub, mul, div, min/max; comparisons not counted)
# per ray/triangle pair of :func:`watertight`, per-ray set-up excluded:
# translate 9, shear 12, three DifferenceOfProducts with their Dekker
# splits 3 x 37, det 2, z scale 3, t_scaled 5, range product 1, 1/det 1,
# t 1, error bound 28, barycentrics 2.
PAIR_FLOPS = 175

# Pairs (rays x triangles) per chunk of the plain version: bounds the
# (F, rays) intermediates to a few hundred MB.
_PLAIN_PAIRS_PER_CHUNK = 1 << 22


def _perm(kz_x, kz_y, vx, vy, vz):
    """Permute (x, y, z) so the ray's dominant axis comes last."""
    pz = torch.where(kz_x, vx, torch.where(kz_y, vy, vz))
    px = torch.where(kz_x, vy, torch.where(kz_y, vz, vx))
    py = torch.where(kz_x, vz, torch.where(kz_y, vx, vy))
    return px, py, pz


def ray_shear(d):
    """Per-ray set-up of the watertight test for directions d (..., 3):
    (kz_x, kz_y, inv_dz, sx, sy), each d.shape[:-1]. kz is the first axis
    of largest |d|; (kx, ky) follow it cyclically."""
    dx, dy, dz = d.unbind(-1)
    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
    kz_x = (adx >= ady) & (adx >= adz)
    kz_y = (~kz_x) & (ady >= adz)
    dxp, dyp, dzp = _perm(kz_x, kz_y, dx, dy, dz)
    inv_dz = 1.0 / dzp
    return kz_x, kz_y, inv_dz, -dxp * inv_dz, -dyp * inv_dz


def watertight(o, ray, tm, tri):
    """The watertight ray/triangle test on broadcasting pairs: origins
    ``o`` = (ox, oy, oz), ``ray`` = ray_shear(d), t_max ``tm`` and the
    triangle's 9 vertex coordinates ``tri`` (p0 xyz, p1 xyz, p2 xyz) all
    broadcast together. Translate, permute, shear, DifferenceOfProducts
    edge functions (4097 split), sign-consistent range test and a
    gamma-bounded t. Returns (t, b1, b2) with t = inf where the pair does
    not hit. The CUDA kernels (csrc/watertight.cuh) do these float32
    operations in this order."""
    kz_x, kz_y, inv_dz, sx, sy = ray

    def sheared(k):
        px, py, pz = _perm(kz_x, kz_y, tri[3 * k] - o[0],
                           tri[3 * k + 1] - o[1], tri[3 * k + 2] - o[2])
        return px + sx * pz, py + sy * pz, pz

    ax, ay, azp = sheared(0)
    bx, by, bzp = sheared(1)
    cx, cy, czp = sheared(2)

    e0 = difference_of_products(bx, cy, by, cx)
    e1 = difference_of_products(cx, ay, cy, ax)
    e2 = difference_of_products(ax, by, ay, bx)
    same_side = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
                ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    nonzero = det != 0.0

    az = inv_dz * azp
    bz = inv_dz * bzp
    cz = inv_dz * czp
    t_scaled = e0 * az + e1 * bz + e2 * cz
    ts = torch.where(det < 0, -t_scaled, t_scaled)
    in_range = (ts > 0.0) & (ts < tm * det.abs())

    inv_det = 1.0 / torch.where(nonzero, det, torch.ones_like(det))
    t = t_scaled * inv_det

    amax = lambda a, b, c: torch.maximum(torch.maximum(a.abs(), b.abs()),
                                         c.abs())
    max_z = amax(az, bz, cz)
    delta_z = fp_gamma(3) * max_z
    max_x = amax(ax, bx, cx)
    max_y = amax(ay, by, cy)
    delta_x = fp_gamma(5) * (max_x + max_z)
    delta_y = fp_gamma(5) * (max_y + max_z)
    delta_e = 2.0 * (fp_gamma(2) * max_x * max_y
                     + delta_y * max_x + delta_x * max_y)
    max_e = amax(e0, e1, e2)
    delta_t = 3.0 * (fp_gamma(3) * max_e * max_z + delta_e * max_z
                     + delta_z * max_e) * inv_det.abs()
    hit = same_side & nonzero & in_range & (t > delta_t)
    return (torch.where(hit, t, torch.full_like(t, math.inf)),
            e1 * inv_det, e2 * inv_det)


def _closest_hit_tri_major(o, d, tm, tris, mask):
    """Watertight test of rays (n,) against triangles (F,) as (F, n)
    tensors; returns (t, idx, b1, b2), each (n,), with inf/-1/0/0 on a
    miss and the lowest index among exact ties."""
    t, e1_det, e2_det = watertight(o.unbind(-1), ray_shear(d), tm,
                                   [c[:, None] for c in tris])
    if mask is not None:
        t = torch.where(mask[:, None], t, torch.full_like(t, math.inf))
    j = torch.argmin(t, dim=0)                          # first of equal mins
    t_best = torch.gather(t, 0, j[None])[0]
    found = torch.isfinite(t_best)
    zero = torch.zeros_like(t_best)
    b1 = torch.where(found, torch.gather(e1_det, 0, j[None])[0], zero)
    b2 = torch.where(found, torch.gather(e2_det, 0, j[None])[0], zero)
    idx = torch.where(found, j, torch.full_like(j, -1)).to(torch.int32)
    return t_best, idx, b1, b2


def mesh_intersect_plain(o, d, t_max, tri_verts, tri_mask=None, chunk=None):
    """Plain PyTorch closest hit of rays o/d (..., 3), t_max (...) against
    triangles ``tri_verts`` (9, F). Returns (t, idx, b1, b2, count) with
    t = inf and idx = -1 on a miss. ``chunk`` rays are tested at a time."""
    batch = o.shape[:-1]
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    tm = t_max.reshape(-1)
    n = o2.shape[0]
    f = tri_verts.shape[1]
    mask = None if tri_mask is None else tri_mask.to(torch.bool)
    if chunk is None:
        chunk = max(1, _PLAIN_PAIRS_PER_CHUNK // max(f, 1))
    outs = [_closest_hit_tri_major(o2[s:s + chunk], d2[s:s + chunk],
                                   tm[s:s + chunk], tri_verts, mask)
            for s in range(0, n, chunk)]
    t, idx, b1, b2 = (torch.cat(x) for x in zip(*outs))
    count = torch.full(batch, f, dtype=torch.int32, device=o.device)
    return (t.reshape(batch), idx.reshape(batch), b1.reshape(batch),
            b2.reshape(batch), count)


def check_tensor(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(o, d, t_max, tri_verts, tri_mask):
    """Launch the CUDA kernel on the current stream; outputs (n,) each."""
    global LAUNCHES
    from computational_ray_tracer_tpu_torch.kernels import build
    dev = o.device
    n = o.numel() // 3
    f = tri_verts.shape[1]
    check_tensor("o", o, (n, 3), torch.float32, dev)
    check_tensor("d", d, (n, 3), torch.float32, dev)
    check_tensor("t_max", t_max, (n,), torch.float32, dev)
    check_tensor("tri_verts", tri_verts, (9, f), torch.float32, dev)
    mask_ptr = None
    if tri_mask is not None:
        check_tensor("tri_mask", tri_mask, (f,), torch.float32, dev)
        mask_ptr = tri_mask.data_ptr()
    lib = build.load_library()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    b2 = torch.empty(n, dtype=torch.float32, device=dev)
    err = lib.crt_mesh_intersect(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), tri_verts.data_ptr(),
        mask_ptr, n, f, t.data_ptr(), idx.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mesh_intersect kernel launch failed: CUDA error "
                           f"{err} ({build.error_string(err)})")
    LAUNCHES += 1
    return t, idx, b1, b2


def mesh_intersect(o, d, t_max, mesh, tri_mask=None):
    """Closest hit of rays against ``mesh`` (same returns as
    ``triangle.mesh_intersect_brute``: t, tri_idx, b1, b2, count).

    CPU tensors run the plain version. CUDA tensors launch the kernel; a
    tensor the kernel does not take (dtype, layout, device) raises."""
    if o.device.type == "cpu":
        return mesh_intersect_plain(o, d, t_max, mesh.tri_verts, tri_mask)
    if o.device.type != "cuda":
        raise ValueError(f"mesh_intersect: unsupported device {o.device}")
    batch = o.shape[:-1]
    mask = None if tri_mask is None else tri_mask.to(torch.float32)
    with torch.no_grad():
        t, idx, b1, b2 = _launch(o.reshape(-1, 3), d.reshape(-1, 3),
                                 t_max.reshape(-1), mesh.tri_verts, mask)
    f = mesh.n_triangles
    count = torch.full(batch, f, dtype=torch.int32, device=o.device)
    return (t.reshape(batch), idx.reshape(batch), b1.reshape(batch),
            b2.reshape(batch), count)

