"""Scene description and unified intersection (``computational_ray_tracer_
tpu/models/scene.py``): spheres and a triangle mesh, the mesh either brute
force or in an octree.

On a CUDA device every mesh query goes through a hand-written kernel: the
brute mesh through ``ops/mesh_intersect_kernel.py`` (the reference needs
``use_pallas=True`` for its kernel), the octree through
``ops/octree_kernel.py`` in its closest-hit and any-hit modes. On the CPU
the same wrappers run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import shapes as shp
from computational_ray_tracer_tpu_torch.ops import triangle as trimod
from computational_ray_tracer_tpu_torch.ops import mesh_intersect_kernel as mik
from computational_ray_tracer_tpu_torch.ops import octree as octmod
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.models.materials import (
    MaterialTable, ROUGH_CONDUCTOR)
from computational_ray_tracer_tpu_torch.models.lights import LightTable

TYPE_NONE, TYPE_SPHERE, TYPE_MESH = 0, 1, 4


@dataclasses.dataclass
class Scene:
    spheres: Optional[shp.SphereTable]
    mesh: Optional[trimod.MeshData]
    materials: MaterialTable
    lights: LightTable
    sphere_mat: Optional[torch.Tensor]
    mesh_tri_mat: Optional[torch.Tensor]   # (F,) material per triangle
    texture: Optional[torch.Tensor]        # (Ht, Wt, 3) sigmoid coeffs
    tri_mask: Optional[torch.Tensor]       # (F,) keep mask
    octree: Optional[octmod.Octree] = None           # host arrays
    packed_octree: Optional[okern.PackedOctree] = None
    wr: float = 100.0                      # world radius (static)
    has_rough: bool = True                 # any GGX material present

    @property
    def device(self):
        return self.materials.kind.device

    def world_radius(self):
        return self.wr

    @classmethod
    def build(cls, materials, lights, spheres=None, mesh=None,
              use_octree=True, octree_capacity=None, texture_rgb=None,
              backface_cull_dir=None, device="cuda"):
        """Host-side assembly as the reference's ``Scene.build``. ``mesh``
        is a MeshData or (MeshData, per-triangle material ids) on
        ``device``; with ``use_octree`` it is put in an octree of leaf
        capacity ``octree_capacity`` (default ``TRIANGLE_CAPACITY``).
        ``backface_cull_dir`` drops the faces whose normal points along
        that direction (the mask goes into the packed octree and the brute
        test).
        ``texture_rgb`` (H, W, 3) linear RGB becomes sigmoid coefficients
        through the sRGB coefficient table."""
        sph = sph_m = None
        if spheres:
            sph = shp.SphereTable.build(spheres, device)
            sph_m = torch.as_tensor([int(s.get("material", 0))
                                     for s in spheres], device=device)
        tri_mat = tri_mask = tree = packed = None
        if mesh is not None:
            mesh, tri_mat = mesh if isinstance(mesh, tuple) else (mesh, None)
            tri_mat = (torch.zeros(mesh.n_triangles, dtype=torch.int64)
                       if tri_mat is None else torch.as_tensor(
                           np.asarray(tri_mat, np.int64)))
            tri_mat = tri_mat.to(device)
            if backface_cull_dir is not None:
                tri_mask = trimod.compute_backface_mask(mesh,
                                                        backface_cull_dir)
            if use_octree:
                cap = (octree_capacity if octree_capacity is not None
                       else octmod.TRIANGLE_CAPACITY)
                tree = octmod.build_octree(mesh.positions.cpu().numpy(),
                                           mesh.indices.cpu().numpy(), cap)
                packed = okern.pack_from_numpy(tree, mesh, tri_mask)
        tex = (None if texture_rgb is None
               else texture_from_rgb(texture_rgb, device))
        mats = (materials if isinstance(materials, MaterialTable)
                else MaterialTable.build(materials, device))
        lts = (lights if isinstance(lights, LightTable)
               else LightTable.build(lights, device))
        r = 1.0
        if mesh is not None:
            r = max(r, float(mesh.positions.abs().max()))
        if sph is not None:
            r = max(r, float(sph.o2w[:, :3, 3].abs().max())
                    + float(sph.radius.abs().max()))
        has_rough = bool((mats.kind == ROUGH_CONDUCTOR).any())
        return cls(sph, mesh, mats, lts, sph_m, tri_mat, tex, tri_mask, tree,
                   packed, wr=10.0 * r, has_rough=has_rough)


def texture_from_rgb(texture_rgb, device):
    """(H, W, 3) linear RGB -> the sigmoid coefficients of each texel
    through the sRGB coefficient table, on ``device``."""
    from computational_ray_tracer_tpu_torch.ops import color
    img = np.asarray(texture_rgb, np.float32)
    tex = color.RGBToSpectrumTable.srgb().lookup(
        torch.as_tensor(img.reshape(-1, 3))).reshape(img.shape)
    return tex.to(device)


def _packet_order(o, d, alive):
    """Permutation sorting rays by (direction octant, 8^3 Morton cell of
    the origin among the alive rays), dead rays last: neighbouring rays of
    the sorted wavefront walk the same subtrees. The reference's key, with
    a stable argsort in place of its radix sort."""
    octant = ((d[..., 0] < 0).to(torch.int32) * 4
              + (d[..., 1] < 0).to(torch.int32) * 2
              + (d[..., 2] < 0).to(torch.int32))
    inf = torch.full_like(o, float("inf"))
    lo = torch.where(alive[..., None], o, inf).amin(0)
    hi = torch.where(alive[..., None], o, -inf).amax(0)
    q = torch.clamp(((o - lo) / torch.clamp(hi - lo, min=1e-20) * 8.0)
                    .to(torch.int32), 0, 7)

    def spread3(v):
        v = (v | (v << 4)) & 0x0C3
        return (v | (v << 2)) & 0x249

    morton = spread3(q[..., 0]) | (spread3(q[..., 1]) << 1) \
        | (spread3(q[..., 2]) << 2)
    key = torch.where(alive, octant * 512 + morton,
                      torch.full_like(morton, 1 << 14))
    return torch.argsort(key, stable=True)


def _mesh_closest_hit(scene, o, d, t_best):
    if scene.packed_octree is not None:
        return okern.octree_intersect(o, d, t_best, scene.packed_octree)
    return mik.mesh_intersect(o.contiguous(), d.contiguous(),
                              t_best.contiguous(), scene.mesh,
                              scene.tri_mask)[:4]


def scene_intersect_t(scene: Scene, o, d, t_max):
    """Hit-distance phase: (t_best, type_best, idx_best, b1, b2)."""
    batch = o.shape[:-1]
    t_best = t_max
    type_best = torch.zeros(batch, dtype=torch.int64, device=o.device)
    idx_best = torch.zeros(batch, dtype=torch.int64, device=o.device)
    b1 = torch.zeros(batch, device=o.device)
    b2 = torch.zeros(batch, device=o.device)
    if scene.spheres is not None:
        t_all = shp.sphere_intersect_t(o, d, t_best, scene.spheres)
        j = torch.argmin(t_all, dim=-1)                # first of equal mins
        tb = torch.gather(t_all, -1, j[..., None])[..., 0]
        better = tb < t_best
        t_best = torch.where(better, tb, t_best)
        type_best = torch.where(better, TYPE_SPHERE, type_best)
        idx_best = torch.where(better, j, idx_best)
    if scene.mesh is not None:
        tm, ti, mb1, mb2 = _mesh_closest_hit(scene, o, d, t_best)
        better = tm < t_best
        t_best = torch.where(better, tm, t_best)
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
        p=z3, n=torch.zeros_like(o) + torch.tensor([0.0, 0.0, 1.0],
                                                   device=o.device),
        uv=torch.zeros(batch + (2,), device=o.device), dpdu=z3, dpdv=z3,
        wo=-d, backface=torch.zeros(batch, dtype=torch.bool, device=o.device))
    mat_id = torch.zeros(batch, dtype=torch.int64, device=o.device)
    t_surf = torch.where(valid, t_best, torch.ones_like(t_best))
    if scene.spheres is not None:
        m = valid & (type_best == TYPE_SPHERE)
        idx = torch.clamp(idx_best, 0, scene.spheres.radius.shape[0] - 1)
        si = _merge(si, shp.sphere_surface(o, d, t_surf, idx, scene.spheres),
                    m)
        mat_id = torch.where(m, scene.sphere_mat[idx], mat_id)
    if scene.mesh is not None:
        m = valid & (type_best == TYPE_MESH)
        idx = torch.clamp(idx_best, 0, scene.mesh.n_triangles - 1)
        si = _merge(si, trimod.mesh_surface(o, d, t_surf, idx, b1, b2,
                                            scene.mesh), m)
        mat_id = torch.where(m, scene.mesh_tri_mat[idx], mat_id)
    si.t = t_hit
    si.valid = valid
    return si, mat_id


def scene_intersect(scene: Scene, o, d, t_max):
    """Closest hit across all shape types: (SurfaceInfo, material id)."""
    return scene_surface(scene, o, d, scene_intersect_t(scene, o, d, t_max))


def scene_anyhit(scene: Scene, o, d, t_max):
    """Does anything intersect in (0, t_max)? The octree takes the rays in
    packet order: sorted, traced and scattered back, which changes no
    value (the reference sorts its incoherent shadow wavefronts)."""
    hit = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    if scene.spheres is not None:
        t_all = shp.sphere_intersect_t(o, d, t_max, scene.spheres)
        hit = hit | (t_all < t_max[..., None]).any(-1)
    if scene.mesh is None:
        return hit
    t_m = torch.where(hit, torch.zeros_like(t_max), t_max)
    if scene.packed_octree is None:
        return hit | (_mesh_closest_hit(scene, o, d, t_m)[1] >= 0)
    of, df, tf = o.reshape(-1, 3), d.reshape(-1, 3), t_m.reshape(-1)
    order = _packet_order(of, df, tf > 0.0)
    h = okern.octree_anyhit(of[order], df[order], tf[order],
                            scene.packed_octree)
    unsorted = torch.empty_like(h)
    unsorted[order] = h
    return hit | unsorted.reshape(t_m.shape)


def scene_occluded(scene: Scene, p, wi, dist, eps, n):
    """Shadow-ray predicate: is anything between p and p + wi*dist? The
    origin is offset along n, signed toward wi's hemisphere."""
    s = torch.sign(torch.sum(wi * n, dim=-1))
    o = p + n * (s * eps)[..., None]
    return scene_anyhit(scene, o, wi, dist * (1.0 - 1e-3) - eps)


def texture_lookup(texture, uv):
    """Bilinear fetch of sigmoid coefficients from the texture image."""
    h, w, _ = texture.shape
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (w - 1)
    y = torch.clamp(1.0 - uv[..., 1], 0.0, 1.0) * (h - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return ((1 - fy) * ((1 - fx) * texture[y0, x0] + fx * texture[y0, x0 + 1])
            + fy * ((1 - fx) * texture[y0 + 1, x0]
                    + fx * texture[y0 + 1, x0 + 1]))
