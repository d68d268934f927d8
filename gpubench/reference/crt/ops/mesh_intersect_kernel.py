"""Brute-force mesh closest hit and any hit, the plain PyTorch versions of
the CUDA kernel (``csrc/mesh_intersect.cu``) and port of
``computational_ray_tracer_tpu/ops/pallas_intersect.py`` and the jnp
``triangle.mesh_intersect_brute`` / ``mesh_anyhit_brute`` it mirrors: the
watertight test in triangle-major layout over chunks of rays, with the
float32 Dekker split of ``ops/shapes.py``. The CUDA kernel performs the
same float32 operations in the same order, without FMA contraction, so the
two agree bit for bit.

Outputs are detached (hit ids and barycentrics are sampling decisions; the
reference gives them zero tangents).
"""

from __future__ import annotations

import math

import torch

from gpubench.reference.crt.ops.shapes import (
    difference_of_products, fp_gamma)

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
    return _watertight(o, ray, tm, tri)[:3]


def _watertight(o, ray, tm, tri):
    """:func:`watertight`, then whether each pair passes the edge-sign
    test, whether it passes the range test as well, the first barycentric
    b0 and whether the pair hits."""
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
    ranged = same_side & nonzero & in_range
    return (torch.where(hit, t, torch.full_like(t, math.inf)),
            e1 * inv_det, e2 * inv_det, same_side, ranged, e0 * inv_det, hit)


def _tri_major(o, d, tm, tris, keep, anyhit):
    """Watertight test of rays (n,) against triangles (F,) as (F, n)
    tensors. Returns (t, idx, b1, b2), each (n,), with inf/-1/0/0 on a miss
    and the lowest index among exact ties, or with ``anyhit`` (hit,)."""
    t, e1_det, e2_det, _, _, _, _ = _watertight(
        o.unbind(-1), ray_shear(d), tm, [c[:, None] for c in tris])
    if keep is not None:
        t = torch.where(keep[:, None], t, torch.full_like(t, math.inf))
    if anyhit:
        return (torch.isfinite(t).any(0),)
    j = torch.argmin(t, dim=0)                          # first of equal mins
    t_best = torch.gather(t, 0, j[None])[0]
    found = torch.isfinite(t_best)
    zero = torch.zeros_like(t_best)
    b1 = torch.where(found, torch.gather(e1_det, 0, j[None])[0], zero)
    b2 = torch.where(found, torch.gather(e2_det, 0, j[None])[0], zero)
    idx = torch.where(found, j, torch.full_like(j, -1)).to(torch.int32)
    return t_best, idx, b1, b2


def _plain(o, d, t_max, tri_verts, tri_mask, anyhit):
    """The plain version over chunks of rays; outputs shaped as the rays'
    batch."""
    batch = o.shape[:-1]
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    tm = t_max.reshape(-1)
    f = tri_verts.shape[1]
    keep = None if tri_mask is None else tri_mask.to(torch.bool)
    chunk = max(1, _PLAIN_PAIRS_PER_CHUNK // max(f, 1))
    outs = [_tri_major(o2[s:s + chunk], d2[s:s + chunk], tm[s:s + chunk],
                       tri_verts, keep, anyhit)
            for s in range(0, o2.shape[0], chunk)]
    return tuple(torch.cat(x).reshape(batch) for x in zip(*outs))


def mesh_intersect(o, d, t_max, mesh, tri_mask=None):
    """Closest hit of rays o/d (..., 3), t_max (...) against ``mesh``:
    (t, tri_idx, b1, b2) with t = inf and tri_idx = -1 on a miss."""
    return _plain(o, d, t_max, mesh.tri_verts, tri_mask, False)


def mesh_anyhit(o, d, t_max, mesh, tri_mask=None):
    """Occlusion of rays against ``mesh``: is any triangle hit in
    (0, t_max)? (...,) bool."""
    return _plain(o, d, t_max, mesh.tri_verts, tri_mask, True)[0]
