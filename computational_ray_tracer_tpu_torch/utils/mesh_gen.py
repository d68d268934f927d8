"""Procedural meshes (``computational_ray_tracer_tpu/utils/mesh_gen.py``):
the Cornell box of the headline scene, in numpy."""

from __future__ import annotations

import numpy as np


def quad(corner, edge1, edge2, flip=False):
    """Two triangles covering a parallelogram: (positions (4, 3), indices
    (2, 3), uvs (4, 2)); the winding normal is cross(edge1, edge2)."""
    c = np.asarray(corner, np.float32)
    e1 = np.asarray(edge1, np.float32)
    e2 = np.asarray(edge2, np.float32)
    pos = np.stack([c, c + e1, c + e1 + e2, c + e2])
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    if flip:
        idx = idx[:, ::-1].copy()
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return pos, idx, uv


def merge_meshes(parts):
    """parts: (positions, indices, uvs[, material]) tuples -> (positions,
    indices, uvs, per-triangle materials)."""
    pos_all, idx_all, uv_all, mat_all = [], [], [], []
    base = 0
    for part in parts:
        pos, idx, uv = part[:3]
        pos_all.append(pos)
        idx_all.append(np.asarray(idx) + base)
        uv_all.append(uv)
        mat_all.append(np.full(len(idx), part[3] if len(part) > 3 else 0,
                               np.int32))
        base += len(pos)
    return (np.concatenate(pos_all), np.concatenate(idx_all),
            np.concatenate(uv_all), np.concatenate(mat_all))


def cornell_box(size=2.0, light_frac=0.5):
    """Five-walled Cornell box in [-s/2, s/2]^3, open toward -z, with a
    downward-facing ceiling light quad. Returns (positions, indices, uvs,
    tri_materials, (corner, edge1, edge2)); materials 0 white, 1 red left,
    2 green right, 3 light."""
    s = size / 2.0
    parts = [
        quad((-s, -s, -s), (0, 0, size), (size, 0, 0)) + (0,),   # floor
        quad((-s, s, -s), (size, 0, 0), (0, 0, size)) + (0,),    # ceiling
        quad((-s, -s, s), (0, size, 0), (size, 0, 0)) + (0,),    # back
        quad((-s, -s, -s), (0, size, 0), (0, 0, size)) + (1,),   # left red
        quad((s, -s, -s), (0, 0, size), (0, size, 0)) + (2,),    # right green
    ]
    lf = light_frac * size / 2.0
    lc = np.asarray([-lf, s - 0.005 * size, -lf], np.float32)
    le1 = np.asarray([2 * lf, 0, 0], np.float32)
    le2 = np.asarray([0, 0, 2 * lf], np.float32)
    parts.append(quad(lc, le1, le2) + (3,))
    pos, idx, uv, mats = merge_meshes(parts)
    return pos, idx, uv, mats, (lc, le1, le2)
