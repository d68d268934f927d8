"""Segment predicates, batched (``computational_ray_tracer_tpu/geometry2d/
segment.py``): orientation and turn tests, segment-segment intersection
with and without the end points, line-line intersection, point-segment
and point-triangle distance, each an elementwise torch function over
points (..., 2)."""

from __future__ import annotations

import torch


def orientation(a, b, c):
    """Signed twice-area of triangle abc: > 0 left turn (CCW), < 0 right."""
    return ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def is_left_turn(a, b, c, eps=0.0):
    return orientation(a, b, c) > eps


def is_right_turn(a, b, c, eps=0.0):
    return orientation(a, b, c) < -eps


def collinear(a, b, c, eps=1e-9):
    return orientation(a, b, c).abs() <= eps


def on_segment(p, a, b, eps=1e-7):
    """Is p on segment ab (end points included)?"""
    col = orientation(a, b, p).abs() <= eps * (
        1.0 + p.abs().sum(-1) + a.abs().sum(-1) + b.abs().sum(-1))
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    within = ((p[..., 0] >= lo[..., 0] - eps) & (p[..., 0] <= hi[..., 0] + eps)
              & (p[..., 1] >= lo[..., 1] - eps)
              & (p[..., 1] <= hi[..., 1] + eps))
    return col & within


def segments_intersect(a, b, c, d, include_endpoints=True):
    """Do segments ab and cd intersect? ``include_endpoints=False`` asks
    for a proper (interior) crossing."""
    d1 = orientation(c, d, a)
    d2 = orientation(c, d, b)
    d3 = orientation(a, b, c)
    d4 = orientation(a, b, d)
    proper = (((d1 > 0) & (d2 < 0)) | ((d1 < 0) & (d2 > 0))) & \
             (((d3 > 0) & (d4 < 0)) | ((d3 < 0) & (d4 > 0)))
    if not include_endpoints:
        return proper
    touch = (on_segment(a, c, d) | on_segment(b, c, d)
             | on_segment(c, a, b) | on_segment(d, a, b))
    return proper | touch


def _cross(u, v):
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def line_line_intersection(a, b, c, d):
    """Intersection point of the infinite lines ab and cd: (point,
    parallel mask)."""
    r = b - a
    s = d - c
    denom = _cross(r, s)
    parallel = denom.abs() < 1e-12
    dn = torch.where(parallel, torch.ones_like(denom), denom)
    t = _cross(c - a, s) / dn
    return a + t[..., None] * r, parallel


def segment_segment_intersection_point(a, b, c, d):
    """Intersection point of segments ab and cd (valid where they
    intersect): (point, t along ab, u along cd, valid)."""
    r = b - a
    s = d - c
    denom = _cross(r, s)
    parallel = denom.abs() < 1e-12
    dn = torch.where(parallel, torch.ones_like(denom), denom)
    qp = c - a
    t = _cross(qp, s) / dn
    u = _cross(qp, r) / dn
    valid = (~parallel & (t >= -1e-9) & (t <= 1 + 1e-9)
             & (u >= -1e-9) & (u <= 1 + 1e-9))
    return a + t[..., None] * r, t, u, valid


def point_segment_distance(p, a, b):
    """Euclidean distance from p to segment ab."""
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-20)
    t = torch.clamp(torch.sum((p - a) * ab, dim=-1) / denom, 0.0, 1.0)
    return torch.linalg.norm(p - (a + t[..., None] * ab), dim=-1)


def point_triangle_distance(p, a, b, c):
    """Distance from p to triangle abc, 0 inside."""
    o1, o2, o3 = (orientation(u, v, p) for u, v in ((a, b), (b, c), (c, a)))
    inside = ((o1 >= 0) & (o2 >= 0) & (o3 >= 0)) | (
        (o1 <= 0) & (o2 <= 0) & (o3 <= 0))
    d = torch.minimum(point_segment_distance(p, a, b),
                      torch.minimum(point_segment_distance(p, b, c),
                                    point_segment_distance(p, c, a)))
    return torch.where(inside, torch.zeros_like(d), d)
