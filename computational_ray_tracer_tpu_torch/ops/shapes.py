"""Analytic shapes (``computational_ray_tracer_tpu/ops/shapes.py``): the
surface record, exact-product arithmetic, transforms, bounds, and the
clipped sphere, cylinder and disk. Each shape kind is a table of parameters
(leading axis = shape count) placed by 4x4 object->world transforms;
``*_intersect_t`` gives the hit distances of every (ray, shape) pair and
``*_surface`` the surface record of each ray's winning shape."""

from __future__ import annotations

import dataclasses
import math

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


def make_transform(translate=(0, 0, 0), rotate_deg=(0, 0, 0), scale=1.0):
    """Host-side 4x4 object->world matrix (+ inverse), rotations X then Y
    then Z, in float64 then cast to float32."""
    t = np.asarray(translate, np.float64)
    s = np.asarray(scale, np.float64) * np.ones(3)
    rx, ry, rz = [math.radians(a) for a in rotate_deg]
    cx, sx_ = math.cos(rx), math.sin(rx)
    cy, sy_ = math.cos(ry), math.sin(ry)
    cz, sz_ = math.cos(rz), math.sin(rz)
    r = (np.array([[cz, -sz_, 0], [sz_, cz, 0], [0, 0, 1]])
         @ np.array([[cy, 0, sy_], [0, 1, 0], [-sy_, 0, cy]])
         @ np.array([[1, 0, 0], [0, cx, -sx_], [0, sx_, cx]]))
    m = np.eye(4)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = t
    return m.astype(np.float32), np.linalg.inv(m).astype(np.float32)


def transform_point(m, p):
    """(..., 4, 4) x (..., 3) -> (..., 3)."""
    return (m[..., :3, :3] @ p[..., None])[..., 0] + m[..., :3, 3]


def transform_vector(m, v):
    return (m[..., :3, :3] @ v[..., None])[..., 0]


def transform_normal(m_inv, n):
    """Normals transform by the inverse transpose."""
    return (m_inv[..., :3, :3].transpose(-1, -2) @ n[..., None])[..., 0]


def transform_ray(m, o, d):
    return transform_point(m, o), transform_vector(m, d)


def bounds_union(lo_a, hi_a, lo_b, hi_b):
    return torch.minimum(lo_a, lo_b), torch.maximum(hi_a, hi_b)


def transform_bounds(m, lo, hi):
    """The AABB of an AABB's 8 transformed corners."""
    corners = []
    for ix in (0, 1):
        for iy in (0, 1):
            for iz in (0, 1):
                c = torch.stack([(hi if ix else lo)[..., 0],
                                 (hi if iy else lo)[..., 1],
                                 (hi if iz else lo)[..., 2]], dim=-1)
                corners.append(transform_point(m, c))
    cs = torch.stack(corners, dim=0)
    return cs.amin(0), cs.amax(0)


def bounds_intersect_p(o, inv_d, t_max, lo, hi):
    """Slab test with t_far inflated by 1 + 2 gamma(3); a NaN slab (a
    parallel ray with its origin on the slab) passes."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1)
    t_far = torch.maximum(t0, t1) * (1.0 + 2.0 * fp_gamma(3))
    t_near = torch.where(torch.isnan(t_near), -math.inf, t_near)
    t_far = torch.where(torch.isnan(t_far), math.inf, t_far)
    enter = t_near.amax(-1)
    exit_ = t_far.amin(-1)
    return (enter <= exit_) & (exit_ > 0.0) & (enter < t_max)


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


def stable_quadratic(a, b, c):
    """Roots (t0 <= t1, has_roots) of a t^2 + b t + c, PBRT-stable form."""
    disc = difference_of_products(b, b, 4.0 * a, c)
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.sign(b) * root)
    q = torch.where(b == 0.0, -0.5 * root, q)
    t0 = q / torch.where(a == 0.0, torch.ones_like(a), a)
    t1 = c / torch.where(q == 0.0, torch.ones_like(q), q)
    return torch.minimum(t0, t1), torch.maximum(t0, t1), disc >= 0.0


@dataclasses.dataclass
class SphereTable:
    """SoA parameters for M spheres, clipped by z and phi."""
    radius: torch.Tensor   # (M,)
    z_min: torch.Tensor
    z_max: torch.Tensor
    phi_max: torch.Tensor
    o2w: torch.Tensor      # (M, 4, 4)
    w2o: torch.Tensor

    @classmethod
    def build(cls, spheres, device="cpu"):
        rad, zmin, zmax, pmax, o2w, w2o = [], [], [], [], [], []
        for s in spheres:
            r = float(s["radius"])
            rad.append(r)
            zmin.append(float(s.get("z_min", -r)))
            zmax.append(float(s.get("z_max", r)))
            pmax.append(float(s.get("phi_max", 2.0 * math.pi)))
            m, mi = s.get("transform") or make_transform()
            o2w.append(m)
            w2o.append(mi)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        return cls(f(rad), f(zmin), f(zmax), f(pmax), f(np.stack(o2w)),
                   f(np.stack(w2o)))


def _phi(px, py):
    phi = torch.atan2(py, px)
    return torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)


def sphere_intersect_t(o, d, t_max, tab: SphereTable):
    """Hit distances (..., M), inf where missed; a clipped-out near root
    retries the far root."""
    batch = o.shape[:-1]
    tm = t_max.reshape(-1)
    oo, od = _object_space(o, d, tab.w2o)
    r = tab.radius[:, None]
    a = od[0] * od[0] + od[1] * od[1] + od[2] * od[2]
    b = 2.0 * (od[0] * oo[0] + od[1] * oo[1] + od[2] * oo[2])
    c = oo[0] * oo[0] + oo[1] * oo[1] + oo[2] * oo[2] - r * r
    t0, t1, has = stable_quadratic(a, b, c)

    def clip_ok(t):
        px = oo[0] + od[0] * t
        py = oo[1] + od[1] * t
        pz = oo[2] + od[2] * t
        s = r / torch.clamp(torch.sqrt(px * px + py * py + pz * pz),
                            min=1e-20)
        px, py, pz = px * s, py * s, pz * s
        return ((pz >= tab.z_min[:, None]) & (pz <= tab.z_max[:, None])
                & (_phi(px, py) <= tab.phi_max[:, None]))

    eps = 1e-4 * r
    t0_ok = has & (t0 > eps) & (t0 < tm) & clip_ok(t0)
    t1_ok = has & (t1 > eps) & (t1 < tm) & clip_ok(t1)
    inf = torch.full_like(t0, math.inf)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, inf))
    return t.T.reshape(batch + (tab.w2o.shape[0],))


def sphere_surface(o, d, t, idx, tab: SphereTable):
    """Surface info for each ray's winning sphere ``idx``."""
    w2o = tab.w2o[idx]
    o2w = tab.o2w[idx]
    r = tab.radius[idx]
    phi_max = tab.phi_max[idx]
    z_min = tab.z_min[idx]
    z_max = tab.z_max[idx]
    oo, od = transform_ray(w2o, o, d)
    p = oo + od * t[..., None]
    p = p * (r / torch.clamp(torch.linalg.norm(p, dim=-1), min=1e-20))[..., None]
    phi = _phi(p[..., 0], p[..., 1])
    theta = torch.arccos(torch.clamp(p[..., 2] / r, -1.0, 1.0))
    theta_min = torch.arccos(torch.clamp(z_max / r, -1, 1))
    theta_max = torch.arccos(torch.clamp(z_min / r, -1, 1))
    u = phi / phi_max
    v = (theta - theta_min) / torch.clamp(theta_max - theta_min, min=1e-9)
    z_r = torch.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 1] ** 2, min=1e-20))
    cos_phi = p[..., 0] / z_r
    sin_phi = p[..., 1] / z_r
    dpdu = torch.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                        torch.zeros_like(phi)], dim=-1)
    dpdv = (theta_max - theta_min)[..., None] * torch.stack(
        [p[..., 2] * cos_phi, p[..., 2] * sin_phi, -r * torch.sin(theta)],
        dim=-1)
    n_obj = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                            min=1e-20)
    return _finish_surface(o2w, w2o, d, t, p, n_obj, u, v, dpdu, dpdv)


def _finish_surface(o2w, w2o, d, t, p_obj, n_obj, u, v, dpdu_obj,
                    dpdv_obj):
    """The world-space record of an object-space hit; the normal is
    flipped toward wo and ``backface`` records the flip."""
    pw = transform_point(o2w, p_obj)
    nw = transform_normal(w2o, n_obj)
    nw = nw / torch.clamp(torch.linalg.norm(nw, dim=-1, keepdim=True),
                          min=1e-20)
    wo = -d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                          min=1e-20)
    flip = torch.sum(nw * wo, dim=-1, keepdim=True) < 0.0
    return SurfaceInfo(
        t=t, valid=torch.isfinite(t), p=pw, n=torch.where(flip, -nw, nw),
        uv=torch.stack([u, v], dim=-1), dpdu=transform_vector(o2w, dpdu_obj),
        dpdv=transform_vector(o2w, dpdv_obj), wo=wo, backface=flip[..., 0])


def _table(cls, fields, items, device):
    """A shape table from dicts: ``fields`` maps a column to (dict key,
    default; None where the key is required); each item's ``transform`` is
    a make_transform pair (identity if absent)."""
    cols = {name: [] for name in fields}
    o2w, w2o = [], []
    for s in items:
        for name, (key, default) in fields.items():
            cols[name].append(float(s[key] if default is None
                                    else s.get(key, default)))
        m, mi = s.get("transform") or make_transform()
        o2w.append(m)
        w2o.append(mi)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return cls(*[f(c) for c in cols.values()], f(np.stack(o2w)),
               f(np.stack(w2o)))


def _object_space(o, d, w2o):
    """Rays (n, 3) in every shape's object space: two triples of (M, n)."""
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    mc = lambda r, c: w2o[:, r, c][:, None]                       # (M, 1)
    oo = tuple(mc(r, 0) * o2[:, 0] + mc(r, 1) * o2[:, 1]
               + mc(r, 2) * o2[:, 2] + mc(r, 3) for r in range(3))
    od = tuple(mc(r, 0) * d2[:, 0] + mc(r, 1) * d2[:, 1]
               + mc(r, 2) * d2[:, 2] for r in range(3))
    return oo, od


@dataclasses.dataclass
class CylinderTable:
    """x^2 + y^2 = r^2 for z in [z_min, z_max], phi <= phi_max."""
    radius: torch.Tensor
    z_min: torch.Tensor
    z_max: torch.Tensor
    phi_max: torch.Tensor
    o2w: torch.Tensor
    w2o: torch.Tensor

    @classmethod
    def build(cls, cylinders, device="cpu"):
        return _table(cls, {"radius": ("radius", None),
                            "z_min": ("z_min", -1.0), "z_max": ("z_max", 1.0),
                            "phi_max": ("phi_max", 2.0 * math.pi)},
                      cylinders, device)


def cylinder_intersect_t(o, d, t_max, tab: CylinderTable):
    """Hit distances (..., M), inf where missed; a clipped-out near root
    retries the far root."""
    batch = o.shape[:-1]
    tm = t_max.reshape(-1)
    oo, od = _object_space(o, d, tab.w2o)
    r = tab.radius[:, None]
    a = od[0] * od[0] + od[1] * od[1]
    b = 2.0 * (od[0] * oo[0] + od[1] * oo[1])
    c = oo[0] * oo[0] + oo[1] * oo[1] - r * r
    t0, t1, has = stable_quadratic(a, b, c)

    def clip_ok(t):
        px = oo[0] + od[0] * t
        py = oo[1] + od[1] * t
        pz = oo[2] + od[2] * t
        hit_r = torch.sqrt(torch.clamp(px * px + py * py, min=1e-20))
        return ((pz >= tab.z_min[:, None]) & (pz <= tab.z_max[:, None])
                & (_phi(px, py) <= tab.phi_max[:, None]) & (hit_r > 0))

    eps = 1e-4 * r
    t0_ok = has & (t0 > eps) & (t0 < tm) & clip_ok(t0)
    t1_ok = has & (t1 > eps) & (t1 < tm) & clip_ok(t1)
    inf = torch.full_like(t0, math.inf)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, inf))
    return t.T.reshape(batch + (tab.w2o.shape[0],))


def cylinder_surface(o, d, t, idx, tab: CylinderTable):
    """Surface info for each ray's winning cylinder ``idx``."""
    w2o = tab.w2o[idx]
    r = tab.radius[idx]
    phi_max = tab.phi_max[idx]
    z_min = tab.z_min[idx]
    z_max = tab.z_max[idx]
    oo, od = transform_ray(w2o, o, d)
    p = oo + od * t[..., None]
    hit_r = torch.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 1] ** 2,
                                   min=1e-20))
    p = torch.stack([p[..., 0] * r / hit_r, p[..., 1] * r / hit_r,
                     p[..., 2]], dim=-1)
    u = _phi(p[..., 0], p[..., 1]) / phi_max
    v = (p[..., 2] - z_min) / torch.clamp(z_max - z_min, min=1e-9)
    zero = torch.zeros_like(u)
    dpdu = torch.stack([-phi_max * p[..., 1], phi_max * p[..., 0], zero],
                       dim=-1)
    dpdv = torch.stack([zero, zero, torch.ones_like(u)], dim=-1) \
        * (z_max - z_min)[..., None]
    n_obj = torch.stack([p[..., 0], p[..., 1], zero], dim=-1)
    n_obj = n_obj / torch.clamp(torch.linalg.norm(n_obj, dim=-1,
                                                  keepdim=True), min=1e-20)
    return _finish_surface(tab.o2w[idx], w2o, d, t, p, n_obj, u, v, dpdu,
                           dpdv)


@dataclasses.dataclass
class DiskTable:
    """The annulus inner_radius <= r <= radius at z = height, phi <=
    phi_max."""
    height: torch.Tensor
    radius: torch.Tensor
    inner_radius: torch.Tensor
    phi_max: torch.Tensor
    o2w: torch.Tensor
    w2o: torch.Tensor

    @classmethod
    def build(cls, disks, device="cpu"):
        return _table(cls, {"height": ("height", 0.0),
                            "radius": ("radius", None),
                            "inner_radius": ("inner_radius", 0.0),
                            "phi_max": ("phi_max", 2.0 * math.pi)},
                      disks, device)


def disk_intersect_t(o, d, t_max, tab: DiskTable):
    """Hit distances (..., M), inf where missed (rays parallel to the
    plane miss)."""
    batch = o.shape[:-1]
    tm = t_max.reshape(-1)
    oo, od = _object_space(o, d, tab.w2o)
    dz = od[2]
    parallel = dz.abs() < 1e-9
    t = (tab.height[:, None] - oo[2]) / torch.where(
        parallel, torch.ones_like(dz), dz)
    px = oo[0] + od[0] * t
    py = oo[1] + od[1] * t
    r2 = px * px + py * py
    radius = tab.radius[:, None]
    eps = 1e-4 * radius
    ok = (~parallel & (t > eps) & (t < tm)
          & (r2 <= radius ** 2) & (r2 >= tab.inner_radius[:, None] ** 2)
          & (_phi(px, py) <= tab.phi_max[:, None]))
    t = torch.where(ok, t, torch.full_like(t, math.inf))
    return t.T.reshape(batch + (tab.w2o.shape[0],))


def disk_surface(o, d, t, idx, tab: DiskTable):
    """Surface info for each ray's winning disk ``idx``."""
    w2o = tab.w2o[idx]
    radius = tab.radius[idx]
    inner = tab.inner_radius[idx]
    phi_max = tab.phi_max[idx]
    oo, od = transform_ray(w2o, o, d)
    p = oo + od * t[..., None]
    r_hit = torch.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 1] ** 2,
                                   min=1e-20))
    u = _phi(p[..., 0], p[..., 1]) / phi_max
    v = (radius - r_hit) / torch.clamp(radius - inner, min=1e-9)
    zero = torch.zeros_like(u)
    dpdu = torch.stack([-phi_max * p[..., 1], phi_max * p[..., 0], zero],
                       dim=-1)
    dpdv = torch.stack([p[..., 0], p[..., 1], zero], dim=-1) \
        * ((inner - radius) / torch.clamp(r_hit, min=1e-9))[..., None]
    n_obj = torch.stack([zero, zero, torch.ones_like(u)], dim=-1)
    return _finish_surface(tab.o2w[idx], w2o, d, t, p, n_obj, u, v, dpdu,
                           dpdv)
