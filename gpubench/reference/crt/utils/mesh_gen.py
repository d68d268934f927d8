"""Procedural meshes (``computational_ray_tracer_tpu/utils/mesh_gen.py``),
in numpy: the Cornell box and the dragon stand-in (from icospheres). Every
generator gives arrays bit-identical to the reference's. The dragon
stand-in is cached on disk (``utils/asset_cache.py``) as the reference
caches it."""

from __future__ import annotations

import math

import numpy as np

from gpubench.reference.crt.utils import asset_cache

_MESH_ARRAYS = ("verts", "faces", "uvs")


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


def icosphere(subdiv=3, radius=1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron projected to a sphere: 20*4^subdiv faces with
    shared vertices (subdiv 7 gives 327,680 triangles), spherical uvs."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.asarray([
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int64)
    for _ in range(subdiv):
        nv = verts.shape[0]
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
        e_sorted = np.sort(e, axis=1)
        key = e_sorted[:, 0] * (nv + 1) + e_sorted[:, 1]
        uniq, inv = np.unique(key, return_inverse=True)
        mid_pairs = np.stack([uniq // (nv + 1), uniq % (nv + 1)], axis=1)
        mids = verts[mid_pairs[:, 0]] + verts[mid_pairs[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_ids = nv + inv.reshape(3, -1)
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        ab, bc, ca = mid_ids[0], mid_ids[1], mid_ids[2]
        faces = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([b, bc, ab], axis=1),
            np.stack([c, ca, bc], axis=1),
            np.stack([ab, bc, ca], axis=1)])
        verts = np.concatenate([verts, mids])
    verts = np.asarray(center, np.float64) + radius * verts
    rel = verts - np.asarray(center, np.float64)
    u = 0.5 + np.arctan2(rel[:, 1], rel[:, 0]) / (2 * math.pi)
    v = 0.5 - np.arcsin(np.clip(rel[:, 2] / radius, -1, 1)) / math.pi
    uvs = np.stack([u, v], axis=1)
    return (verts.astype(np.float32), faces.astype(np.int32),
            uvs.astype(np.float32))


def dragon_stand_in(target_tris=870_000, scale=15.0, seed=11):
    """The irregular reference-scale mesh (~870k triangles at x15 scale): a
    helical chain of beads whose radii span ~30x and whose subdivision
    levels differ, so triangle areas vary by orders of magnitude and the
    density follows a curve. (positions, faces, uvs), deterministic in the
    arguments; read from the asset cache, or generated and stored there."""
    key = f"dragon_stand_in_v1_t{target_tris}_s{scale}_seed{seed}"
    return asset_cache.cached(
        key, lambda: _dragon_stand_in(target_tris, scale, seed), _MESH_ARRAYS)


def _dragon_stand_in(target_tris, scale, seed):
    rng_ = np.random.RandomState(seed)
    base = {s: icosphere(s, 1.0, (0.0, 0.0, 0.0)) for s in (2, 3, 4, 5)}

    def curve(t, lap):
        ang = 6.0 * math.pi * t + 2.1 * lap
        rad_curve = (0.55 - 0.35 * t) * (1.0 + 0.55 * lap)
        y = 1.6 * (t - 0.5)
        return np.asarray([rad_curve * math.cos(ang), y,
                           rad_curve * math.sin(ang)])

    parts_v, parts_f, parts_uv = [], [], []
    total = 0
    voff = 0

    def emit(center, r, subdiv):
        nonlocal total, voff
        v, f, uv = base[subdiv]
        q = rng_.normal(size=(3, 3))
        u_, _, vt = np.linalg.svd(q)
        rot = u_ @ vt
        noise = 1.0 + 0.12 * np.sin(
            7.0 * v @ rng_.normal(size=3) + rng_.uniform(0, 6.28))
        vv = (v * noise[:, None]) @ rot.T * r + center
        parts_v.append(vv)
        parts_f.append(f + voff)
        parts_uv.append(uv)
        voff += v.shape[0]
        total += f.shape[0]

    lap = 0
    while total < target_tris:
        t = 0.0
        while t < 1.0 and total < target_tris:
            r = (0.015 + 0.17 * (1.0 - t) ** 2) * rng_.lognormal(0.0, 0.12)
            subdiv = 2 + int(np.clip(np.log2(r / 0.01) / 1.5, 0, 3))
            emit(curve(t, lap), r, subdiv)
            if rng_.rand() < 0.3:
                off = rng_.normal(size=3)
                off /= np.linalg.norm(off)
                emit(curve(t, lap) + off * r, 0.4 * r, subdiv)
            t += 0.75 * r / (0.9 + 2.0)
        lap += 1

    verts = (np.concatenate(parts_v) * scale).astype(np.float32)
    faces = np.concatenate(parts_f).astype(np.int32)
    uvs = np.concatenate(parts_uv).astype(np.float32)
    return verts, faces, uvs


