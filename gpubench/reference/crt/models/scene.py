"""Scene description and intersection (``computational_ray_tracer_tpu/
models/scene.py``), cut to a triangle mesh, brute force or in an octree.

Mesh queries go through the kernel wrappers' plain versions: the brute
mesh through ``ops/mesh_intersect_kernel.py`` (closest and any hit), the
octree through ``ops/octree_kernel.py`` (closest hit).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpubench.reference.crt.ops import shapes as shp
from gpubench.reference.crt.ops import triangle as trimod
from gpubench.reference.crt.ops import mesh_intersect_kernel as mik
from gpubench.reference.crt.ops import octree as octmod
from gpubench.reference.crt.ops import octree_kernel as okern
from gpubench.reference.crt.models.materials import MaterialTable
from gpubench.reference.crt.models.lights import LightTable

TYPE_NONE, TYPE_MESH = 0, 4


@dataclasses.dataclass
class Scene:
    mesh: trimod.MeshData
    materials: MaterialTable
    lights: LightTable
    mesh_tri_mat: torch.Tensor             # (F,) material per triangle
    tri_mask: Optional[torch.Tensor]       # (F,) keep mask
    packed_octree: Optional[okern.PackedOctree] = None
    wr: float = 100.0                      # world radius (static)

    @property
    def device(self):
        return self.materials.kind.device

    def world_radius(self):
        return self.wr

    @classmethod
    def build(cls, materials, lights, mesh, use_octree=True,
              backface_cull_dir=None, octree_capacity=None, device="cuda"):
        """Host-side assembly as the reference's ``Scene.build``: ``mesh``
        is (MeshData, per-triangle material ids) on ``device``; with
        ``use_octree`` it is put in an octree of leaf capacity
        ``octree_capacity`` (default ``TRIANGLE_CAPACITY``), built through
        ``octree.build_host_octree``'s disk cache. ``backface_cull_dir``
        drops the faces whose normal points along that direction (the mask
        goes into the packed octree and the brute test)."""
        mesh, tri_mat = mesh
        tri_mat = torch.as_tensor(np.asarray(tri_mat, np.int64)).to(device)
        tri_mask = packed = None
        if backface_cull_dir is not None:
            tri_mask = trimod.compute_backface_mask(mesh, backface_cull_dir)
        if use_octree:
            cap = (octree_capacity if octree_capacity is not None
                   else octmod.TRIANGLE_CAPACITY)
            tree = octmod.build_host_octree(*octmod.host_mesh_arrays(mesh),
                                            cap)
            packed = okern.pack_from_numpy(tree, mesh, tri_mask)
        mats = MaterialTable.build(materials, device)
        lts = LightTable.build(lights, device)
        r = max(1.0, float(mesh.positions.abs().max()))
        return cls(mesh, mats, lts, tri_mat, tri_mask, packed, wr=10.0 * r)


def scene_intersect_t(scene: Scene, o, d, t_max):
    """Hit-distance phase: (t_best, type_best, idx_best, b1, b2)."""
    batch = o.shape[:-1]
    type_best = torch.zeros(batch, dtype=torch.int64, device=o.device)
    idx_best = torch.zeros(batch, dtype=torch.int64, device=o.device)
    b1 = torch.zeros(batch, device=o.device)
    b2 = torch.zeros(batch, device=o.device)
    if scene.packed_octree is not None:
        tm, ti, mb1, mb2 = okern.octree_intersect(o, d, t_max,
                                                  scene.packed_octree)[:4]
    else:
        tm, ti, mb1, mb2 = mik.mesh_intersect(
            o.contiguous(), d.contiguous(), t_max.contiguous(), scene.mesh,
            scene.tri_mask)[:4]
    better = tm < t_max
    t_best = torch.where(better, tm, t_max)
    type_best = torch.where(better, TYPE_MESH, type_best)
    idx_best = torch.where(better, ti.to(torch.int64), idx_best)
    b1 = torch.where(better, mb1, b1)
    b2 = torch.where(better, mb2, b2)
    return t_best, type_best, idx_best, b1, b2


def _merge(si, new, mask):
    mv = mask[..., None]
    return shp.SurfaceInfo(*[
        torch.where(mv if a.ndim > mask.ndim else mask, b, a)
        for a, b in ((si.t, new.t), (si.valid, new.valid), (si.p, new.p),
                     (si.n, new.n), (si.uv, new.uv), (si.dpdu, new.dpdu),
                     (si.dpdv, new.dpdv), (si.wo, new.wo),
                     (si.backface, new.backface))])


def scene_surface(scene: Scene, o, d, hit):
    """Surface info + material id for the winners of scene_intersect_t."""
    t_best, type_best, idx_best, b1, b2 = hit
    valid = torch.isfinite(t_best) & (type_best != TYPE_NONE)
    t_hit = torch.where(valid, t_best, torch.full_like(t_best, float("inf")))
    batch = o.shape[:-1]
    z3 = torch.zeros_like(o)
    si = shp.SurfaceInfo(
        t=t_hit, valid=torch.zeros(batch, dtype=torch.bool, device=o.device),
        p=z3, n=torch.cat([z3[..., :2], torch.ones_like(o[..., :1])], -1),
        uv=torch.zeros(batch + (2,), device=o.device), dpdu=z3, dpdv=z3,
        wo=-d, backface=torch.zeros(batch, dtype=torch.bool, device=o.device))
    mat_id = torch.zeros(batch, dtype=torch.int64, device=o.device)
    t_surf = torch.where(valid, t_best, torch.ones_like(t_best))
    m = valid & (type_best == TYPE_MESH)
    idx = torch.clamp(idx_best, 0, scene.mesh.n_triangles - 1)
    si = _merge(si, trimod.mesh_surface(o, d, t_surf, idx, b1, b2,
                                        scene.mesh), m)
    mat_id = torch.where(m, scene.mesh_tri_mat[idx], mat_id)
    si.t = t_hit
    si.valid = valid
    return si, mat_id


def scene_intersect(scene: Scene, o, d, t_max):
    """Closest hit: (SurfaceInfo, material id)."""
    hit = scene_intersect_t(scene, o, d, t_max)
    return scene_surface(scene, o, d, hit)


def scene_anyhit(scene: Scene, o, d, t_max):
    """Does anything intersect in (0, t_max)? The brute-force mesh only:
    the cells' octree scene casts no shadow rays."""
    if scene.packed_octree is not None:
        raise NotImplementedError("octree any hit is not in the copy")
    return mik.mesh_anyhit(o.contiguous(), d.contiguous(),
                           t_max.contiguous(), scene.mesh, scene.tri_mask)


def scene_occluded(scene: Scene, p, wi, dist, eps=1e-3, n=None):
    """Shadow-ray predicate: is anything between p and p + wi*dist? The
    origin is offset by ``eps`` (per ray or one value) along n, signed
    toward wi's hemisphere, or along wi when ``n`` is None."""
    eps = torch.as_tensor(eps, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1])
    if n is None:
        o = p + wi * eps[..., None]
    else:
        s = torch.sign(torch.sum(wi * n, dim=-1))
        o = p + n * (s * eps)[..., None]
    return scene_anyhit(scene, o, wi, dist * (1.0 - 1e-3) - eps)
