"""Octree over a triangle mesh (``computational_ray_tracer_tpu/ops/
octree.py``): the host-side NumPy build and the plain PyTorch traversal.

The build is one-shot scene set-up, kept in a content-keyed disk cache
(:func:`build_host_octree`): a top-down split with leaf capacity
``capacity``, child bounds padded by a fraction of the child's extent, the
split aborted when it separates nothing, the Moller triangle/box overlap
test, and a post-pass that splits over-full leaves into chains of
same-bounds children. It gives the same six arrays as the reference's
builder, bit for bit.

:func:`octree_traverse` is the reference's lockstep traversal in PyTorch
and the plain version of the CUDA traversal kernel
(``ops/octree_kernel.py``, which packs the tree for it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

from gpubench.reference.crt.ops import mesh_intersect_kernel as mik
from gpubench.reference.crt.ops.shapes import fp_gamma
from gpubench.reference.crt.utils import asset_cache

TRIANGLE_CAPACITY = 40
# Child-bounds padding as a fraction of the child box's extent (per axis,
# per level). The reference's builder function defaults to 0.01, but its
# build_octree always passes this fraction; so does build_octree here.
CHILD_PADDING_FRAC = 5e-4
MAX_DEPTH = 12
# Deepest leaf the traversals take (the over-full-leaf split can go past
# MAX_DEPTH). A node-stack traversal pops one entry and pushes at most 8 per
# level, so 7 * depth + 1 entries always suffice; the CUDA kernel's
# per-thread stack has this size (kMaxTreeDepth in csrc/octree_traverse.cu)
# and pack_from_numpy refuses deeper trees.
MAX_TREE_DEPTH = 24
STACK_SIZE = 7 * MAX_TREE_DEPTH + 1
# (rays x leaf capacity) pairs per leaf-test chunk of the plain traversal.
_LEAF_PAIRS_PER_CHUNK = 1 << 22
# Part of the disk cache's key: bump it when the builder or the over-full-
# leaf split changes the tree it gives for the same inputs.
BUILDER_VERSION = "numpy_v1"
TREE_FIELDS = ("node_lo", "node_hi", "node_child0", "node_leaf_id",
                "leaf_tris", "leaf_counts")


@dataclasses.dataclass
class Octree:
    """Flat octree: node bounds, the first of 8 contiguous children (-1 for
    a leaf), each node's leaf id (-1 for an interior node), and per-leaf
    triangle lists padded with -1 to the largest leaf."""
    node_lo: np.ndarray        # (M, 3) float32
    node_hi: np.ndarray        # (M, 3) float32
    node_child0: np.ndarray    # (M,) int32
    node_leaf_id: np.ndarray   # (M,) int32
    leaf_tris: np.ndarray      # (L, cap) int32
    leaf_counts: np.ndarray    # (L,) int32

    @property
    def n_nodes(self):
        return self.node_lo.shape[0]

    def to(self, device):
        """The same tree as tensors on ``device`` (ids as int64), the
        input of :func:`octree_traverse`."""
        t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt,
                                       device=device)
        return Octree(t(self.node_lo, torch.float32),
                      t(self.node_hi, torch.float32),
                      t(self.node_child0, torch.int64),
                      t(self.node_leaf_id, torch.int64),
                      t(self.leaf_tris, torch.int64),
                      t(self.leaf_counts, torch.int64))


def _tri_box_overlap(center, half, v0, v1, v2):
    """Separating-axis test of triangles (K, 3) x 3 against one box:
    (K,) bool."""
    v0 = v0 - center
    v1 = v1 - center
    v2 = v2 - center
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2

    def axis_test(a, b, fa, fb, va, vb, i, j):
        p0 = a * va[:, i] - b * va[:, j]
        p1 = a * vb[:, i] - b * vb[:, j]
        rad = fa * half[i] + fb * half[j]
        return (np.minimum(p0, p1) <= rad) & (np.maximum(p0, p1) >= -rad)

    ok = np.ones(v0.shape[0], dtype=bool)
    for (e, pair) in ((e0, (v0, v2)), (e1, (v0, v2)), (e2, (v0, v1))):
        fe = np.abs(e)
        ok &= axis_test(e[:, 2], e[:, 1], fe[:, 2], fe[:, 1],
                        pair[0], pair[1], 1, 2)
        ok &= axis_test(-e[:, 2], -e[:, 0], fe[:, 2], fe[:, 0],
                        pair[0], pair[1], 0, 2)
        ok &= axis_test(e[:, 1], e[:, 0], fe[:, 1], fe[:, 0],
                        pair[0], pair[1], 0, 1)
    for i in range(3):
        lo = np.minimum(np.minimum(v0[:, i], v1[:, i]), v2[:, i])
        hi = np.maximum(np.maximum(v0[:, i], v1[:, i]), v2[:, i])
        ok &= (lo <= half[i]) & (hi >= -half[i])
    n = np.cross(e0, e1)
    d = -np.sum(n * v0, axis=1)
    r = np.sum(np.abs(n) * half[None, :], axis=1)
    ok &= np.abs(d) <= r
    return ok


def _build_octree_numpy(pos_np, idx_np, capacity, max_depth, padding):
    """Top-down build in float64 (bounds stored as float32)."""
    pos = np.asarray(pos_np, np.float64)
    idx = np.asarray(idx_np, np.int64)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]

    nodes_lo, nodes_hi, child0, leaf_id = [], [], [], []
    leaves = []

    def add_node(lo, hi):
        nodes_lo.append(lo)
        nodes_hi.append(hi)
        child0.append(-1)
        leaf_id.append(-1)
        return len(nodes_lo) - 1

    root = add_node(pos.min(axis=0) - 1e-4, pos.max(axis=0) + 1e-4)
    work = [(root, np.arange(idx.shape[0]), 0)]
    while work:
        nid, tris, depth = work.pop()
        lo = nodes_lo[nid]
        hi = nodes_hi[nid]
        if len(tris) <= capacity or depth >= max_depth:
            leaf_id[nid] = len(leaves)
            leaves.append(tris)
            continue
        mid = (lo + hi) / 2.0
        pad = padding * (np.asarray(hi) - np.asarray(lo)) * 0.5
        child_sets = []
        child_bounds = []
        for ix in (0, 1):
            for iy in (0, 1):
                for iz in (0, 1):
                    clo = np.array([lo[0] if ix == 0 else mid[0],
                                    lo[1] if iy == 0 else mid[1],
                                    lo[2] if iz == 0 else mid[2]])
                    chi = np.array([mid[0] if ix == 0 else hi[0],
                                    mid[1] if iy == 0 else hi[1],
                                    mid[2] if iz == 0 else hi[2]])
                    clo_p = clo - pad
                    chi_p = chi + pad
                    sel = _tri_box_overlap((clo_p + chi_p) / 2.0,
                                           (chi_p - clo_p) / 2.0,
                                           v0[tris], v1[tris], v2[tris])
                    child_sets.append(tris[sel])
                    child_bounds.append((clo_p, chi_p))
        # abort rule: the split separated nothing
        if max(len(s) for s in child_sets) >= len(tris):
            leaf_id[nid] = len(leaves)
            leaves.append(tris)
            continue
        child0[nid] = len(nodes_lo)
        for (clo, chi), s in zip(child_bounds, child_sets):
            work.append((add_node(clo, chi), s, depth + 1))

    cap = max(max((len(t) for t in leaves), default=1), 1)
    leaf_tris = np.full((len(leaves), cap), -1, np.int32)
    leaf_counts = np.zeros(len(leaves), np.int32)
    for i, t in enumerate(leaves):
        leaf_tris[i, :len(t)] = t
        leaf_counts[i] = len(t)
    return Octree(np.asarray(nodes_lo, np.float32),
                  np.asarray(nodes_hi, np.float32),
                  np.asarray(child0, np.int32), np.asarray(leaf_id, np.int32),
                  leaf_tris, leaf_counts)


def _split_oversized_leaves(tree: Octree, cap):
    """A leaf holding more than ``cap`` triangles (the abort and max-depth
    exits make them) becomes an interior node whose 8 children share its
    bounds and split its list evenly, recursively; empty children get dead
    (inverted) bounds. Any ray reaching those bounds tests the same
    triangles, so results do not change; the leaf width drops to ``cap``."""
    counts = tree.leaf_counts
    if counts.size == 0 or counts.max() <= cap:
        return tree
    node_lo = list(tree.node_lo)
    node_hi = list(tree.node_hi)
    child0 = list(tree.node_child0)
    leaf_id = list(tree.node_leaf_id)
    leaves = [tree.leaf_tris[i, :counts[i]] for i in range(len(counts))]
    dead_lo = np.full(3, 1e30, np.float32)
    dead_hi = np.full(3, -1e30, np.float32)

    new_leaves = {}
    work = [n for n in range(len(child0))
            if leaf_id[n] >= 0 and counts[leaf_id[n]] > cap]
    tris_of = {n: leaves[leaf_id[n]] for n in work}
    for n in work:
        leaf_id[n] = -1
    while work:
        n = work.pop()
        tris = tris_of.pop(n)
        base = len(child0)
        child0[n] = base
        for c, chunk in enumerate(np.array_split(tris, 8)):
            child0.append(-1)
            if len(chunk) == 0:
                node_lo.append(dead_lo)
                node_hi.append(dead_hi)
                leaf_id.append(-2)             # empty filler leaf
            else:
                node_lo.append(node_lo[n])
                node_hi.append(node_hi[n])
                if len(chunk) > cap:
                    leaf_id.append(-1)
                    work.append(base + c)
                    tris_of[base + c] = chunk
                else:
                    leaf_id.append(-3)         # new leaf
                    new_leaves[base + c] = chunk

    out_tris, out_counts = [], []
    for n in range(len(child0)):
        if leaf_id[n] == -2:
            t = np.zeros((0,), np.int64)
        elif leaf_id[n] == -3:
            t = new_leaves[n]
        elif leaf_id[n] >= 0:
            t = leaves[leaf_id[n]]
        else:
            continue
        leaf_id[n] = len(out_tris)
        out_tris.append(t)
        out_counts.append(len(t))
    new_cap = max(max(out_counts, default=1), 1)
    flat = np.full((len(out_tris), new_cap), -1, np.int32)
    for i, t in enumerate(out_tris):
        flat[i, :len(t)] = t
    return Octree(np.asarray(node_lo, np.float32),
                  np.asarray(node_hi, np.float32),
                  np.asarray(child0, np.int32), np.asarray(leaf_id, np.int32),
                  flat, np.asarray(out_counts, np.int32))


def _cache_key(pos, idx, capacity, max_depth, padding):
    """blake2b of the mesh bytes and every build parameter."""
    h = hashlib.blake2b(digest_size=16)
    h.update(pos.tobytes())
    h.update(idx.tobytes())
    h.update(f"{BUILDER_VERSION}_c{capacity}_d{max_depth}"
             f"_p{padding!r}".encode())
    return f"octree_{h.hexdigest()}"


def build_host_octree(positions, indices, capacity=TRIANGLE_CAPACITY,
                      max_depth=MAX_DEPTH, padding=None):
    """Octree (host arrays) over a world-space mesh given as host arrays,
    positions (V, 3) and indices (F, 3): the NumPy build with the child
    padding ``padding`` (a fraction of each child box's extent; None:
    ``CHILD_PADDING_FRAC``), then the over-full-leaf split.

    The built tree is kept in ``utils/asset_cache`` under a key of the
    mesh bytes and the parameters, so a cached tree is the rebuilt one bit
    for bit."""
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    if padding is None:
        padding = CHILD_PADDING_FRAC
    key = _cache_key(pos, idx, capacity, max_depth, padding)
    hit = asset_cache.load(key)
    if hit is not None and all(f in hit for f in TREE_FIELDS):
        return Octree(**{f: hit[f] for f in TREE_FIELDS})
    tree = _split_oversized_leaves(
        _build_octree_numpy(pos, idx, capacity, max_depth, padding),
        capacity)
    asset_cache.store(key, **{f: getattr(tree, f) for f in TREE_FIELDS})
    return tree


def host_mesh_arrays(mesh):
    """(positions float32 (V, 3), indices int32 (F, 3)) of a MeshData as
    host arrays."""
    return (mesh.positions.detach().cpu().numpy().astype(np.float32),
            mesh.indices.cpu().numpy().astype(np.int32))


def tree_depth(tree: Octree):
    """Depth of the deepest leaf (the root has depth 0). Children are
    always allocated after their parent, so one pass in id order works."""
    depth = np.zeros(tree.n_nodes, np.int64)
    for n in np.nonzero(tree.node_child0 >= 0)[0]:
        depth[tree.node_child0[n]:tree.node_child0[n] + 8] = depth[n] + 1
    return int(depth.max())


def octree_traverse(o, d, t_max, tree: Octree, mesh, tri_mask=None,
                    pops=False):
    """Closest hit of rays o/d (..., 3), t_max (...) in the octree
    ``tree`` (tensors, :meth:`Octree.to`) over the triangles of ``mesh``
    (a MeshData, or its (9, F) ``tri_verts``): the reference's
    ``octree_traverse`` in PyTorch. Returns (t, tri_idx, b1, b2,
    tri_tests) with t = inf and tri_idx = -1 on a miss, then, with
    ``pops``, the node pops of each ray.

    Every ray keeps a node stack: pop a node, slab-test its bounds against
    (0, t_best), push the 8 children of a hit interior node (child 7 pops
    first) or test a hit leaf's triangles with the brute plain version's
    watertight test against t_best, keeping the first of equal minima. The
    pops run in lockstep over the rays still holding stack entries, in the
    reference's order, so the two agree bit for bit."""
    tri_verts = getattr(mesh, "tri_verts", mesh)
    batch = o.shape[:-1]
    dev = o.device
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = o.shape[0]
    # The reference's guard for axis-parallel directions (its Pallas
    # kernel uses +-1e-20 instead; this is the oracle's form).
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.sign(d) * 1e-20 + 1e-30,
                              d)
    ray = mik.ray_shear(d)
    g3 = 1.0 + 2.0 * fp_gamma(3)
    cap = tree.leaf_tris.shape[1]
    mask = None if tri_mask is None else tri_mask.to(torch.bool)

    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)   # root in slot 0
    t_best = t_max.reshape(-1).clone()
    pop_count = torch.zeros(n, dtype=torch.int32, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b1_best = torch.zeros(n, device=dev)
    b2_best = torch.zeros(n, device=dev)
    tests = torch.zeros(n, dtype=torch.int32, device=dev)
    eight = torch.arange(8, device=dev)

    def leaf_test(r, leaf):
        tri = tree.leaf_tris[leaf]                       # (m, cap)
        ok = tri >= 0
        tri = torch.clamp(tri, min=0)
        if mask is not None:
            ok &= mask[tri]
        t, e1d, e2d = mik.watertight(
            o[r].T[:, :, None].unbind(0), [x[r, None] for x in ray],
            t_best[r, None], tri_verts[:, tri])
        t = torch.where(ok, t, torch.full_like(t, math.inf))
        j = torch.argmin(t, dim=1, keepdim=True)         # first of equal mins
        t_leaf = torch.gather(t, 1, j)[:, 0]
        better = t_leaf < t_best[r]
        rb = r[better]
        t_best[rb] = t_leaf[better]
        tri_best[rb] = torch.gather(tri, 1, j)[:, 0][better]
        b1_best[rb] = torch.gather(e1d, 1, j)[:, 0][better]
        b2_best[rb] = torch.gather(e2d, 1, j)[:, 0][better]
        tests[r] += ok.sum(1, dtype=torch.int32)

    active = torch.arange(n, device=dev)
    while active.numel():
        top = sp[active] - 1
        sp[active] = top
        pop_count[active] += 1
        node = stack[active, top]
        oa = o[active]
        t0 = (tree.node_lo[node] - oa) * inv_d[active]
        t1 = (tree.node_hi[node] - oa) * inv_d[active]
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1) * g3
        box = (t_near <= t_far) & (t_far > 0.0) & (t_near < t_best[active])
        c0 = tree.node_child0[node]
        push = box & (c0 >= 0)
        rp = active[push]
        stack[rp[:, None], top[push, None] + eight] = c0[push, None] + eight
        sp[rp] += 8
        leaf = box & (c0 < 0)
        rl = active[leaf]
        lid = tree.node_leaf_id[node[leaf]]
        step = max(1, _LEAF_PAIRS_PER_CHUNK // max(cap, 1))
        for s in range(0, rl.numel(), step):
            leaf_test(rl[s:s + step], lid[s:s + step])
        active = active[sp[active] > 0]

    hit = torch.isfinite(t_best) & (tri_best >= 0)
    out = (torch.where(hit, t_best, torch.full_like(t_best, math.inf)),
           tri_best.to(torch.int32), b1_best, b2_best, tests) + (
               (pop_count,) if pops else ())
    return tuple(x.reshape(batch) for x in out)
