"""Simple 2D polygons (``computational_ray_tracer_tpu/geometry2d/
polygon.py``): editing, queries, ears and mouths, diagonals, ear-clipping
triangulation, point-in-polygon, hit testing, txt import/export and
random simple polygons.

The polygon is host-side NumPy (interactive-scale setup work), as in the
reference; the predicates it asks of single points and edges are the
float32 ``segment`` functions, so its decisions (ears, diagonals,
triangulation) are the reference's. ``points_in_polygon`` is the batched
ray cast on tensors, on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.geometry2d import segment as seg


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


class Polygon:
    """A simple polygon as an ordered vertex list (N, 2), float64."""

    def __init__(self, vertices):
        self.v = np.asarray(vertices, np.float64).reshape(-1, 2).copy()

    # ---- editing ----
    def add_vertex(self, p, index=None):
        p = np.asarray(p, np.float64)
        if index is None:
            self.v = np.vstack([self.v, p])
        else:
            self.v = np.insert(self.v, index, p, axis=0)

    def remove_vertex(self, index):
        self.v = np.delete(self.v, index % len(self.v), axis=0)

    def split_edge(self, index):
        """Insert the midpoint of edge (index, index+1)."""
        n = len(self.v)
        mid = (self.v[index % n] + self.v[(index + 1) % n]) / 2.0
        self.add_vertex(mid, (index % n) + 1)

    def shift(self, delta):
        self.v = self.v + np.asarray(delta, np.float64)

    def shift_vertex(self, index, delta):
        self.v[index % len(self.v)] += np.asarray(delta, np.float64)

    def rotate(self, angle_rad, about=None):
        c = np.asarray(about, np.float64) if about is not None \
            else self.centroid()
        r = np.array([[math.cos(angle_rad), -math.sin(angle_rad)],
                      [math.sin(angle_rad), math.cos(angle_rad)]])
        self.v = (self.v - c) @ r.T + c

    def scale(self, factor, about=None):
        c = np.asarray(about, np.float64) if about is not None \
            else self.centroid()
        self.v = (self.v - c) * factor + c

    # ---- queries ----
    def __len__(self):
        return len(self.v)

    def centroid(self):
        return self.v.mean(axis=0)

    def signed_area(self):
        x, y = self.v[:, 0], self.v[:, 1]
        return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))

    def area(self):
        return abs(self.signed_area())

    def is_ccw(self):
        return self.signed_area() > 0

    def make_ccw(self):
        if not self.is_ccw():
            self.v = self.v[::-1].copy()
        return self

    def internal_angles(self):
        """Interior angle at each vertex (radians) of a CCW polygon."""
        n = len(self.v)
        a = self.v[(np.arange(n) - 1) % n] - self.v
        b = self.v[(np.arange(n) + 1) % n] - self.v
        ang = np.arctan2(a[:, 1] * b[:, 0] - a[:, 0] * b[:, 1],
                         np.sum(a * b, axis=1))
        return np.where(ang < 0, ang + 2 * math.pi, ang)

    def is_convex_vertex(self, i):
        n = len(self.v)
        o = float(seg.orientation(_f32(self.v[(i - 1) % n]),
                                  _f32(self.v[i % n]),
                                  _f32(self.v[(i + 1) % n])))
        return o > 0 if self.is_ccw() else o < 0

    # ---- containment / hit testing ----
    def contains(self, p):
        """Point-in-polygon ray cast."""
        return bool(points_in_polygon(_f32([p]), _f32(self.v))[0])

    def hit_vertex(self, p, radius):
        """Index of the vertex within ``radius`` of p, or -1."""
        d = np.linalg.norm(self.v - np.asarray(p), axis=1)
        i = int(np.argmin(d))
        return i if d[i] <= radius else -1

    def hit_edge(self, p, radius):
        """Index of the edge (i, i+1) within ``radius`` of p, or -1."""
        d = seg.point_segment_distance(_f32(p), _f32(self.v),
                                       _f32(np.roll(self.v, -1, axis=0)))
        i = int(torch.argmin(d))
        return i if float(d[i]) <= radius else -1

    # ---- diagonals / ears / mouths ----
    def is_diagonal(self, i, j):
        """Is (v_i, v_j) a diagonal: crossing no non-adjacent edge, with
        its midpoint inside?"""
        n = len(self.v)
        i, j = i % n, j % n
        if i == j or (i + 1) % n == j or (j + 1) % n == i:
            return False
        a, b = _f32(self.v[i]), _f32(self.v[j])
        for k in range(n):
            k2 = (k + 1) % n
            if k in (i, j) or k2 in (i, j):
                continue
            if bool(seg.segments_intersect(a, b, _f32(self.v[k]),
                                           _f32(self.v[k2]),
                                           include_endpoints=True)):
                return False
        return self.contains((self.v[i] + self.v[j]) / 2.0)

    def is_ear(self, i):
        """Vertex i is an ear: convex, and (i-1, i+1) is a diagonal."""
        if len(self.v) == 3:
            return True
        return self.is_convex_vertex(i) and self.is_diagonal(i - 1, i + 1)

    def ears(self):
        return [i for i in range(len(self.v)) if self.is_ear(i)]

    def is_mouth(self, i):
        """A reflex vertex whose chord (i-1, i+1) is not a diagonal."""
        if len(self.v) == 3:
            return False
        return (not self.is_convex_vertex(i)) and not self.is_diagonal(
            i - 1, i + 1)

    def mouths(self):
        return [i for i in range(len(self.v)) if self.is_mouth(i)]

    # ---- triangulation ----
    def triangulate(self):
        """Ear-clipping triangulation of a simple polygon: (T, 3) int32
        indices into the vertex array."""
        poly = Polygon(self.v)
        poly_idx = list(range(len(self.v)))
        if not poly.is_ccw():
            poly.v = poly.v[::-1].copy()
            poly_idx = poly_idx[::-1]
        tris = []
        guard = 0
        while len(poly.v) > 3 and guard < 10000:
            guard += 1
            for i in range(len(poly.v)):
                if poly.is_ear(i):
                    n = len(poly.v)
                    tris.append((poly_idx[(i - 1) % n], poly_idx[i],
                                 poly_idx[(i + 1) % n]))
                    poly.v = np.delete(poly.v, i, axis=0)
                    poly_idx.pop(i)
                    break
            else:
                raise RuntimeError("no ear found (non-simple polygon?)")
        tris.append(tuple(poly_idx))
        return np.asarray(tris, np.int32)

    # ---- IO ----
    def save_txt(self, path):
        with open(path, "w") as f:
            for p in self.v:
                f.write(f"{p[0]} {p[1]}\n")

    @classmethod
    def load_txt(cls, path):
        pts = []
        with open(path) as f:
            for line in f:
                t = line.split()
                if len(t) >= 2:
                    pts.append((float(t[0]), float(t[1])))
        return cls(pts)

    @classmethod
    def random_simple(cls, n, rng=None, r_min=0.5, r_max=1.5):
        """Star-shaped random polygon from a NumPy ``Generator``: sorted
        angles and random radii (always simple)."""
        rng = rng or np.random.default_rng()
        ang = np.sort(rng.uniform(0, 2 * math.pi, n))
        rad = rng.uniform(r_min, r_max, n)
        return cls(np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1))


def points_in_polygon(points, vertices):
    """Batched point-in-polygon ray cast: points (N, 2) against the polygon
    (M, 2), both on one device. Returns (N,) bool."""
    px = points[..., 0:1]
    py = points[..., 1:2]
    ax = vertices[None, :, 0]
    ay = vertices[None, :, 1]
    bx = torch.roll(vertices[:, 0], -1)[None, :]
    by = torch.roll(vertices[:, 1], -1)[None, :]
    cond = (ay > py) != (by > py)
    dy = by - ay
    denom = torch.where(dy == 0.0, torch.full_like(dy, 1e-30), dy)
    x_int = ax + (py - ay) * (bx - ax) / denom
    crossing = cond & (px < x_int)
    return torch.sum(crossing, dim=-1) % 2 == 1
