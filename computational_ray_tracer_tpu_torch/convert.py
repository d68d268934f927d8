"""Build the port's Scene from the reference Scene's leaves as numpy arrays,
so both packages render from bit-identical parameters.

``scene_from_numpy(arrays, device)`` takes a flat dict (the tests export it
from a JAX ``Scene``; nothing here imports jax):

- ``materials.<leaf>`` for the 7 MaterialTable leaves and ``lights.<leaf>``
  for the 7 LightTable leaves;
- optionally ``spheres.{radius,z_min,z_max,phi_max,o2w,w2o}`` and
  ``sphere_mat``, ``cylinders.{radius,z_min,z_max,phi_max,o2w,w2o}`` and
  ``cylinder_mat``, ``disks.{height,radius,inner_radius,phi_max,o2w,w2o}``
  and ``disk_mat``;
- optionally ``mesh.{positions,normals,uvs,tangents,bitangents,indices}``
  and ``mesh_tri_mat``, and ``tri_mask``;
- optionally the six arrays of the reference's ``Octree`` as
  ``octree.{node_lo,node_hi,node_child0,node_leaf_id,leaf_tris,
  leaf_counts}``, packed here with the port's own packer, so both packages
  traverse the identical tree;
- optionally ``texture``, the (Ht, Wt, 3) sigmoid coefficients;
- ``wr`` (world radius).

``params_from_numpy(tree, device)`` turns the reference's parameter dict of
``models/inverse.py`` (``albedo_coeffs``, ``emission``, ``light_scale`` as
numpy arrays) into the port's leaf tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.models import lights as lgt
from computational_ray_tracer_tpu_torch.models import materials as mat
from computational_ray_tracer_tpu_torch.models.scene import Scene
from computational_ray_tracer_tpu_torch.ops import octree as octmod
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.ops import shapes as shp
from computational_ray_tracer_tpu_torch.ops import triangle as trimod

SPHERE_FIELDS = ("radius", "z_min", "z_max", "phi_max", "o2w", "w2o")
CYLINDER_FIELDS = SPHERE_FIELDS
DISK_FIELDS = ("height", "radius", "inner_radius", "phi_max", "o2w", "w2o")
# (prefix, table class, its fields, material-id key) of each shape kind
SHAPE_TABLES = (("spheres", shp.SphereTable, SPHERE_FIELDS, "sphere_mat"),
                ("cylinders", shp.CylinderTable, CYLINDER_FIELDS,
                 "cylinder_mat"),
                ("disks", shp.DiskTable, DISK_FIELDS, "disk_mat"))
MESH_FIELDS = ("positions", "normals", "uvs", "tangents", "bitangents",
               "indices")
OCTREE_FIELDS = tuple(f.name for f in dataclasses.fields(octmod.Octree))


def _sub(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + ".")}


def scene_from_numpy(arrays: dict, device="cuda") -> Scene:
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
    materials = mat.MaterialTable.from_arrays(_sub(arrays, "materials"),
                                              device)
    lights = lgt.LightTable.from_arrays(_sub(arrays, "lights"), device)
    shapes = {}
    for prefix, cls, fields, mat_key in SHAPE_TABLES:
        if prefix + ".radius" in arrays:
            sub = _sub(arrays, prefix)
            shapes[prefix] = cls(*[f32(sub[k]) for k in fields])
            shapes[mat_key] = i64(arrays[mat_key])
    mesh = tri_mat = tri_mask = tree = packed = tex = None
    if "mesh.positions" in arrays:
        mesh = trimod.MeshData.from_arrays(
            *[_sub(arrays, "mesh")[k] for k in MESH_FIELDS], device=device)
        tri_mat = i64(arrays["mesh_tri_mat"])
        if arrays.get("tri_mask") is not None:
            tri_mask = torch.tensor(np.asarray(arrays["tri_mask"], bool),
                                    device=device)
        if "octree.node_lo" in arrays:
            oc = _sub(arrays, "octree")
            tree = octmod.Octree(*[np.asarray(oc[k]) for k in OCTREE_FIELDS])
            packed = okern.pack_from_numpy(tree, mesh, tri_mask)
    if arrays.get("texture") is not None:
        tex = f32(arrays["texture"])
    has_rough = bool((materials.kind == mat.ROUGH_CONDUCTOR).any())
    return Scene(shapes.pop("spheres", None), mesh, materials, lights,
                 shapes.pop("sphere_mat", None), tri_mat, tex, tri_mask, tree,
                 packed, wr=float(arrays["wr"]), has_rough=has_rough,
                 **shapes)


def params_from_numpy(tree: dict, device="cuda", requires_grad=True) -> dict:
    """The reference's inverse-rendering parameters (numpy arrays) as
    float32 tensors on ``device``, leaves that require grad by default."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=requires_grad)
            for k, v in tree.items()}
