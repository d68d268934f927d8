"""Build the port's Scene from the reference Scene's leaves as numpy arrays,
so both packages render from bit-identical parameters.

``scene_from_numpy(arrays, device)`` takes a flat dict (the tests export it
from a JAX ``Scene``; nothing here imports jax):

- ``materials.<leaf>`` for the 7 MaterialTable leaves and ``lights.<leaf>``
  for the 7 LightTable leaves;
- optionally ``spheres.{radius,z_min,z_max,phi_max,o2w,w2o}`` and
  ``sphere_mat``;
- optionally ``mesh.{positions,normals,uvs,tangents,bitangents,indices}``
  and ``mesh_tri_mat``, and ``tri_mask``;
- ``wr`` (world radius).
"""

from __future__ import annotations

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.models import lights as lgt
from computational_ray_tracer_tpu_torch.models import materials as mat
from computational_ray_tracer_tpu_torch.models.scene import Scene
from computational_ray_tracer_tpu_torch.ops import shapes as shp
from computational_ray_tracer_tpu_torch.ops import triangle as trimod

SPHERE_FIELDS = ("radius", "z_min", "z_max", "phi_max", "o2w", "w2o")
MESH_FIELDS = ("positions", "normals", "uvs", "tangents", "bitangents",
               "indices")


def _sub(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + ".")}


def scene_from_numpy(arrays: dict, device="cpu") -> Scene:
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
    materials = mat.MaterialTable.from_arrays(_sub(arrays, "materials"),
                                              device)
    lights = lgt.LightTable.from_arrays(_sub(arrays, "lights"), device)
    spheres = sphere_mat = None
    if "spheres.radius" in arrays:
        sp = _sub(arrays, "spheres")
        spheres = shp.SphereTable(*[f32(sp[k]) for k in SPHERE_FIELDS])
        sphere_mat = i64(arrays["sphere_mat"])
    mesh = tri_mat = tri_mask = None
    if "mesh.positions" in arrays:
        mesh = trimod.MeshData.from_arrays(
            *[_sub(arrays, "mesh")[k] for k in MESH_FIELDS], device=device)
        tri_mat = i64(arrays["mesh_tri_mat"])
        if arrays.get("tri_mask") is not None:
            tri_mask = torch.tensor(np.asarray(arrays["tri_mask"], bool),
                                    device=device)
    has_rough = bool((materials.kind == mat.ROUGH_CONDUCTOR).any())
    return Scene(spheres, mesh, materials, lights, sphere_mat, tri_mat, None,
                 tri_mask, wr=float(arrays["wr"]), has_rough=has_rough)
