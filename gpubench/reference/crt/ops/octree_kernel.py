"""The packed octree and the closest-hit query: port of
``computational_ray_tracer_tpu/ops/pallas_octree.py``.

- :func:`pack_from_numpy` lays a host octree out as the CUDA kernel
  (``csrc/octree_traverse.cu``) reads it, in the reference's layout: one
  (128,) float32 row per sibling group, 16 floats per child ``[lo.xyz,
  hi.xyz, child_group, leaf_row_off, count, pad]``, the root in slot 7 of
  group 0; leaf triangles pre-gathered into (rows, 128) rows of 8
  triangles at a 16-float stride, each leaf owning ``ceil(count / 16) * 2``
  rows; ``row_tri`` maps a slot to its triangle id (-1 for padding and
  masked triangles, whose rows are zero). The benchmark reads only its
  size (:meth:`PackedOctree.nbytes`, the kernel's bytes of a roofline).
- :func:`octree_intersect` (closest hit) runs the plain traversal
  ``octree.octree_traverse``.

Outputs are detached (hit ids and barycentrics are sampling decisions; the
reference gives them zero tangents).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpubench.reference.crt.ops import octree as octmod

TRI_PER_ROW = 8      # triangles per packed leaf row
TRI_LANES = 16       # floats per triangle slot (9 used)
VERT_COLS = TRI_PER_ROW * TRI_LANES
CHUNK_ROWS = 2       # leaf rows are allocated in steps of 2 (16 triangles)
CHUNK = TRI_PER_ROW * CHUNK_ROWS
NODE_LANES = 16      # floats per child slot in a sibling-group row


@dataclasses.dataclass
class PackedOctree:
    """The kernel's tree (``nodes``, ``leaf_verts``, ``row_tri``, on the
    mesh's device) beside what the plain version traverses: the unpacked
    ``tree`` as tensors, the mesh's (9, F) ``tri_verts`` and ``tri_mask``."""
    nodes: torch.Tensor          # (G, 128) float32 sibling-group rows
    leaf_verts: torch.Tensor     # (rows, 128) float32 packed triangles
    row_tri: torch.Tensor        # (rows * 8,) int32 triangle id per slot
    cap: int                     # largest leaf, rounded up to CHUNK
    depth: int                   # depth of the deepest leaf
    tree: octmod.Octree          # tensors, for octree.octree_traverse
    tri_verts: torch.Tensor
    tri_mask: Optional[torch.Tensor] = None

    def nbytes(self):
        """Bytes of the kernel's three tables."""
        return sum(t.numel() * t.element_size()
                   for t in (self.nodes, self.leaf_verts, self.row_tri))


def pack_from_numpy(tree_np: octmod.Octree, mesh, tri_mask=None):
    """Pack a host octree over ``mesh`` (a MeshData) for the kernel, on the
    mesh's device. Gives the reference's ``pack_from_numpy`` arrays. A
    ``tri_mask`` (F,) bakes dropped triangles in as zero rows. Raises if
    the tree is deeper than the kernel's stack allows."""
    depth = octmod.tree_depth(tree_np)
    if depth > octmod.MAX_TREE_DEPTH:
        raise ValueError(f"octree depth {depth} exceeds MAX_TREE_DEPTH="
                         f"{octmod.MAX_TREE_DEPTH} (the kernel's stack)")
    node_lo = np.asarray(tree_np.node_lo, np.float32)
    node_hi = np.asarray(tree_np.node_hi, np.float32)
    child0 = np.asarray(tree_np.node_child0, np.int32)
    leaf_id = np.asarray(tree_np.node_leaf_id, np.int32)
    leaf_tris = np.asarray(tree_np.leaf_tris, np.int32)
    counts = np.asarray(tree_np.leaf_counts, np.int32)
    n_leaves, cap0 = leaf_tris.shape
    cap = max(-(-cap0 // CHUNK) * CHUNK, CHUNK)

    leaf_rows = -(-counts.astype(np.int64) // CHUNK) * CHUNK_ROWS
    row_off = np.zeros(n_leaves + 1, np.int64)
    np.cumsum(leaf_rows, out=row_off[1:])
    total_rows = int(row_off[-1])

    # Children are allocated 8 at a time from id 1 (the root is 0), so
    # shifting ids by 7 puts the root in slot 7 of group 0 and the 8
    # children of every split in one group row.
    m = node_lo.shape[0]
    if m + 7 >= 1 << 24 or total_rows >= 1 << 24:
        raise ValueError("node and leaf-row ids must be exact in float32")
    interior = child0 >= 0
    if not ((child0[interior] % 8) == 1).all():
        raise ValueError("the builder no longer allocates 8 contiguous "
                         "children")
    groups = (m + 7 + 7) // 8
    is_leaf = ~interior
    lid = np.maximum(leaf_id, 0)
    vals = np.zeros((m, NODE_LANES), np.float32)
    vals[:, 0:3] = node_lo
    vals[:, 3:6] = node_hi
    vals[:, 6] = np.where(is_leaf, -1, (child0 + 7) // 8)
    vals[:, 7] = np.where(is_leaf, row_off[lid], 0)
    vals[:, 8] = np.where(is_leaf, counts[lid], 0)
    # Empty slots: inverted bounds, child_group -1, count 0. Inverted
    # bounds pass the slab test, so slots are gated by child_group/count.
    nodes = np.zeros((groups * 8, NODE_LANES), np.float32)
    nodes[:, 0:3] = 1e30
    nodes[:, 3:6] = -1e30
    nodes[:, 6] = -1
    nodes[7:7 + m] = vals

    row_tri = np.full(total_rows * TRI_PER_ROW, -1, np.int32)
    valid = leaf_tris >= 0
    if tri_mask is not None:
        keep = np.asarray(torch.as_tensor(tri_mask).cpu(), bool)
        valid &= keep[np.maximum(leaf_tris, 0)]
    li, ci = np.nonzero(valid)
    row_tri[row_off[li] * TRI_PER_ROW + ci] = leaf_tris[li, ci]

    dev = mesh.positions.device
    row_tri_t = torch.as_tensor(row_tri, device=dev)
    slots = torch.zeros((row_tri.shape[0], TRI_LANES), device=dev)
    used = row_tri_t >= 0
    slots[used, :9] = mesh.tri_verts[:, row_tri_t[used].long()].T
    mask_t = (None if tri_mask is None
              else torch.as_tensor(tri_mask, device=dev).to(torch.bool))
    return PackedOctree(
        torch.as_tensor(nodes.reshape(groups, 8 * NODE_LANES), device=dev),
        slots.reshape(-1, VERT_COLS), row_tri_t, cap, depth,
        tree_np.to(dev), mesh.tri_verts, mask_t)


def octree_intersect(o, d, t_max, packed: PackedOctree):
    """Closest hit of rays o/d (..., 3), t_max (...) in the octree: (t,
    tri_idx, b1, b2), by the plain traversal."""
    return octmod.octree_traverse(o, d, t_max, packed.tree,
                                  packed.tri_verts, packed.tri_mask)[:4]
