"""Art-gallery visibility polygons (``computational_ray_tracer_tpu/
geometry2d/visibility.py``): the region of a simple polygon seen from a
guard point, by an angular sweep. A ray from the guard through every
vertex and just either side of it meets the boundary first at a point
(one batched rays x edges test on the device); the points sorted by angle
bound the visible region."""

from __future__ import annotations

import math

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.geometry2d import segment as seg
from computational_ray_tracer_tpu_torch.geometry2d.polygon import (
    Polygon, points_in_polygon)


def _f32(a, device="cpu"):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def first_boundary_hit(origin, directions, vertices):
    """Nearest boundary crossing of the rays from ``origin`` (2,) along
    ``directions`` (R, 2) with the polygon's edges (M, 2), all float32 on
    one device: (points (R, 2), t (R,)), t = inf where no edge is met."""
    b = torch.roll(vertices, -1, dims=0)
    e = (b - vertices)[None, :, :]                     # (1, M, 2)
    dd = directions[:, None, :]                        # (R, 1, 2)
    denom = dd[..., 0] * e[..., 1] - dd[..., 1] * e[..., 0]
    parallel = denom.abs() < 1e-12
    dn = torch.where(parallel, torch.ones_like(denom), denom)
    ao = vertices[None, :, :] - origin[None, None, :]
    t = (ao[..., 0] * e[..., 1] - ao[..., 1] * e[..., 0]) / dn
    u = (ao[..., 0] * dd[..., 1] - ao[..., 1] * dd[..., 0]) / dn
    valid = (~parallel) & (t > 1e-6) & (u >= -1e-9) & (u <= 1 + 1e-9)
    t_min = torch.where(valid, t, torch.full_like(t, math.inf)).amin(dim=1)
    return origin[None, :] + t_min[:, None] * directions, t_min


def visibility_polygon(polygon: Polygon, guard, eps=1e-4, device="cuda"):
    """The polygon seen from ``guard``, its vertices sorted CCW around the
    guard; the ray casts run on ``device``."""
    v = np.asarray(polygon.v, np.float64)
    g = np.asarray(guard, np.float64)
    angles = np.arctan2(v[:, 1] - g[1], v[:, 0] - g[0])
    sweep = np.concatenate([angles - eps, angles, angles + eps])
    dirs = np.stack([np.cos(sweep), np.sin(sweep)], axis=1)
    pts, t = first_boundary_hit(_f32(g, device), _f32(dirs, device),
                                _f32(v, device))
    pts = pts.cpu().numpy().astype(np.float64)
    ok = np.isfinite(t.cpu().numpy())
    pts = pts[ok]
    order = np.argsort(np.mod(sweep[ok], 2 * math.pi))
    pts = pts[order]
    keep = [0]
    for i in range(1, len(pts)):
        if np.linalg.norm(pts[i] - pts[keep[-1]]) > 1e-6:
            keep.append(i)
    return Polygon(pts[keep])


def is_visible(polygon: Polygon, p, q, n_checks=32):
    """Are p and q mutually visible inside the polygon: no proper crossing
    of the boundary and the midpoint inside. ``n_checks`` is unused, as in
    the reference."""
    v = _f32(polygon.v)
    crossing = seg.segments_intersect(_f32(p)[None, :], _f32(q)[None, :], v,
                                      torch.roll(v, -1, dims=0),
                                      include_endpoints=False)
    if bool(crossing.any()):
        return False
    return polygon.contains((np.asarray(p) + np.asarray(q)) / 2.0)


def guard_coverage(polygon: Polygon, guards, n_samples=2048, rng=None,
                   device="cuda"):
    """Monte Carlo share of the polygon's area seen by at least one guard.
    The points come from the NumPy ``rng`` (default: seed 0) over the
    bounding box, as the reference draws them."""
    rng = rng or np.random.default_rng(0)
    pts = rng.uniform(polygon.v.min(axis=0), polygon.v.max(axis=0),
                      (n_samples, 2))
    inside = points_in_polygon(_f32(pts, device), _f32(polygon.v, device))
    pts = _f32(pts, device)[inside]
    if len(pts) == 0:
        return 0.0
    covered = torch.zeros(len(pts), dtype=torch.bool, device=device)
    for gpt in guards:
        vis = visibility_polygon(polygon, gpt, device=device)
        covered |= points_in_polygon(pts, _f32(vis.v, device))
    return float(covered.to(torch.float64).mean())
