"""Triangle meshes (``computational_ray_tracer_tpu/ops/triangle.py``): the
flattened mesh, its backface mask and barycentric surface info. The
watertight test lives in ``ops/mesh_intersect_kernel.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpubench.reference.crt.ops.shapes import SurfaceInfo


@dataclasses.dataclass
class MeshData:
    """Flattened triangle mesh in world space; ``indices`` is (F, 3)."""
    positions: torch.Tensor   # (V, 3)
    normals: torch.Tensor     # (V, 3)
    uvs: torch.Tensor         # (V, 2)
    tangents: torch.Tensor    # (V, 3)
    bitangents: torch.Tensor  # (V, 3)
    indices: torch.Tensor     # (F, 3) int64
    _tri_verts: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)

    @classmethod
    def from_arrays(cls, positions, normals, uvs, tangents, bitangents,
                    indices, device="cpu"):
        f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(f(positions), f(normals), f(uvs), f(tangents),
                   f(bitangents), torch.as_tensor(
                       np.asarray(indices, np.int64), device=device))

    @classmethod
    def build(cls, positions, indices, normals=None, uvs=None, tangents=None,
              bitangents=None, transform=None, device="cpu"):
        """Host-side constructor with the reference's attribute defaults:
        area-weighted vertex normals, zero uvs, an arbitrary tangent frame
        (given tangents and bitangents are kept as they are, as there);
        ``transform`` (``shapes.make_transform``'s (m, m_inv)) moves the
        positions and given normals to world space first."""
        pos = np.asarray(positions, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        if transform is not None:
            m = np.asarray(transform[0], np.float32)
            ph = np.concatenate([pos, np.ones_like(pos[:, :1])], axis=1)
            pos = (ph @ m.T)[:, :3]
        if normals is None:
            normals = _vertex_normals(pos, idx)
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)
            if transform is not None:
                normals = normals @ np.asarray(transform[1],
                                               np.float32)[:3, :3]
                nl = np.linalg.norm(normals, axis=1, keepdims=True)
                normals = normals / np.maximum(nl, 1e-12)
        uvs = (np.zeros((pos.shape[0], 2), np.float32) if uvs is None
               else np.asarray(uvs, np.float32).reshape(-1, 2))
        tangents = (_default_frame(normals) if tangents is None
                    else np.asarray(tangents, np.float32).reshape(-1, 3))
        bitangents = (np.cross(normals, tangents) if bitangents is None
                      else np.asarray(bitangents, np.float32).reshape(-1, 3))
        return cls.from_arrays(pos, normals, uvs, tangents, bitangents, idx,
                               device)

    @property
    def n_triangles(self):
        return self.indices.shape[0]

    @property
    def tri_verts(self):
        """(9, F) contiguous float32 [p0 xyz, p1 xyz, p2 xyz] rows — the
        kernel's triangle layout, gathered once per mesh."""
        if self._tri_verts is None:
            i = self.indices
            self._tri_verts = torch.cat(
                [self.positions[i[:, k]].T for k in range(3)]).contiguous()
        return self._tri_verts


def _vertex_normals(pos, idx):
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    vn = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vn, idx[:, k], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(ln, 1e-12)).astype(np.float32)


def _default_frame(normals):
    a = np.where(np.abs(normals[:, :1]) > 0.9,
                 np.asarray([[0.0, 1.0, 0.0]]), np.asarray([[1.0, 0.0, 0.0]]))
    t = np.cross(a, normals)
    ln = np.linalg.norm(t, axis=1, keepdims=True)
    return (t / np.maximum(ln, 1e-12)).astype(np.float32)


def mesh_surface(o, d, t, tri_idx, b1, b2, mesh: MeshData):
    """Barycentric surface info at mesh hits (gather + lerp)."""
    b0 = 1.0 - b1 - b2
    i = mesh.indices[torch.clamp(tri_idx, min=0)]

    def lerp(attr):
        return (b0[..., None] * attr[i[..., 0]] + b1[..., None] * attr[i[..., 1]]
                + b2[..., None] * attr[i[..., 2]])

    p = lerp(mesh.positions)
    n = lerp(mesh.normals)
    uv = lerp(mesh.uvs)
    dpdu = lerp(mesh.tangents)
    dpdv = lerp(mesh.bitangents)
    p0, p1, p2 = (mesh.positions[i[..., k]] for k in range(3))
    nl = torch.linalg.norm(n, dim=-1, keepdim=True)
    ng = torch.linalg.cross(p1 - p0, p2 - p0)
    ng = ng / torch.clamp(torch.linalg.norm(ng, dim=-1, keepdim=True),
                          min=1e-20)
    n = torch.where(nl > 1e-8, n / torch.clamp(nl, min=1e-20), ng)
    wo = -d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                          min=1e-20)
    backface = torch.sum(ng * wo, dim=-1) < 0.0
    flip = torch.sum(n * wo, dim=-1, keepdim=True) < 0.0
    return SurfaceInfo(t=t, valid=torch.isfinite(t) & (tri_idx >= 0), p=p,
                       n=torch.where(flip, -n, n), uv=uv, dpdu=dpdu,
                       dpdv=dpdv, wo=wo, backface=backface)


def compute_backface_mask(mesh: MeshData, look_dir):
    """Per-face visibility against a look direction: True keeps a face
    whose geometric normal points against ``look_dir``."""
    i = mesh.indices
    p0, p1, p2 = (mesh.positions[i[:, k]] for k in range(3))
    fn = torch.linalg.cross(p1 - p0, p2 - p0)
    look = torch.as_tensor(np.asarray(look_dir, np.float32),
                           device=fn.device)
    return torch.sum(fn * look, dim=-1) < 0.0
