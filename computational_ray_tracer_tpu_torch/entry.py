"""The port's scenes, each as (scene, camera, cfg) on ``device`` (the card
by default):

- ``cornell_setup``: the Cornell box of ``__graft_entry__._cornell_setup``
  (12-triangle box + light quad, a metal-Ag conductor sphere, one quad
  light; Sobol sampler, path/MIS at depth 4, gaussian filter, XYZ sensor),
  in the brute-force mesh configuration;
- ``golden2_cornell_path`` and ``golden3_mesh_octree_textured``: golden
  configurations 2 and 3 of ``tests/test_golden.py``;
- ``mesh327k_setup``: the mesh bench of ``bench.py`` (``bench_dragon``): a
  displaced icosphere of 327,680 triangles in an octree of leaf capacity
  192, direct lighting at 512x512.
"""

from __future__ import annotations

import numpy as np

from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models.scene import Scene
from computational_ray_tracer_tpu_torch.ops import camera as cam
from computational_ray_tracer_tpu_torch.ops import shapes as shp
from computational_ray_tracer_tpu_torch.ops import triangle as trimod
from computational_ray_tracer_tpu_torch.utils import mesh_gen

CORNELL_MATERIALS = [
    {"kind": "diffuse", "albedo_rgb": (0.73, 0.73, 0.73)},
    {"kind": "diffuse", "albedo_rgb": (0.65, 0.05, 0.05)},
    {"kind": "diffuse", "albedo_rgb": (0.12, 0.45, 0.15)},
    {"kind": "diffuse", "albedo_rgb": (0.0, 0.0, 0.0),
     "emission_rgb": (1.0, 0.85, 0.6), "emission_scale": 6.0},
]


def cornell_light(lc, le1, le2):
    return {"kind": "quad", "corner": tuple(lc), "edge1": tuple(le1),
            "edge2": tuple(le2), "rgb": (1.0, 0.85, 0.6), "scale": 6.0}


def _cornell_box(res, spp, device):
    """The box's mesh + light scene arguments, camera and render config,
    shared by the headline and the golden configuration."""
    pos, idx, uv, mats, light = mesh_gen.cornell_box(2.0)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv, device=device)
    scene_args = dict(lights=[cornell_light(*light)], mesh=(mesh, mats),
                      use_octree=False, device=device)
    camera = cam.PerspectiveCamera.create((0, 0, -2.8), (res, res),
                                          fov_y=50.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="path", max_depth=4)
    return scene_args, camera, cfg


def cornell_setup(res=32, spp=4, device="cuda"):
    """(scene, camera, cfg) of the headline Cornell render on ``device``."""
    scene_args, camera, cfg = _cornell_box(res, spp, device)
    scene = Scene.build(
        materials=CORNELL_MATERIALS + [
            {"kind": "conductor", "albedo_rgb": (1.0, 1.0, 1.0),
             "metal": "metal-Ag"}],
        spheres=[{"radius": 0.4,
                  "transform": shp.make_transform((-0.35, -0.6, 0.3)),
                  "material": 4}],
        **scene_args)
    return scene, camera, cfg


def golden2_cornell_path(res=32, spp=4, device="cuda"):
    """The golden-image configuration 2 of ``tests/test_golden.py``: the
    Cornell box without the sphere, rendered at depth 4 with Sobol."""
    scene_args, camera, cfg = _cornell_box(res, spp, device)
    return Scene.build(materials=CORNELL_MATERIALS, **scene_args), camera, cfg


def golden3_mesh_octree_textured(res=32, spp=2, device="cuda"):
    """The golden-image configuration 3 of ``tests/test_golden.py``: a
    checker-textured 24x24 uv sphere in an octree, one distant light,
    direct lighting with the independent sampler."""
    pos, idx, uv = mesh_gen.uv_sphere((0.0, 0.0, 0.0), 1.0, n_theta=24,
                                      n_phi=24)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv, device=device)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (1.0, 1.0, 1.0),
                    "use_texture": True}],
        lights=[{"kind": "distant", "direction": (-0.3, -1.0, 0.4),
                 "rgb": (1.0, 1.0, 1.0), "scale": 40.0}],
        mesh=(mesh, np.zeros(mesh.n_triangles, np.int64)), use_octree=True,
        texture_rgb=mesh_gen.checker_texture(32), device=device)
    camera = cam.PerspectiveCamera.create((0, 0.6, -3.2), (res, res),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="independent", spp=spp),
        integrator="direct", max_depth=1)
    return scene, camera, cfg


def mesh327k_setup(res=512, spp=4, subdiv=7, cap=192, device="cuda"):
    """``bench.py``'s mesh bench (``_dragon_scene`` + ``bench_dragon``): a
    displaced icosphere (subdiv 7: 327,680 triangles) in an octree of leaf
    capacity ``cap``, one diffuse material, a distant light and a D65
    ambient light; camera at (0, 0.5, -3.4) looking at the origin, fov 40;
    Sobol sampler, direct lighting."""
    pos, idx, uv = mesh_gen.displaced_icosphere(subdiv)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv, device=device)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.75, 0.71, 0.62)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1.0, 1.0, 1.0), "scale": 4.0},
                {"kind": "ambient", "spd_named": "stdillum-D65",
                 "scale": 0.15}],
        mesh=(mesh, np.zeros(mesh.n_triangles, np.int64)), use_octree=True,
        octree_capacity=cap, device=device)
    camera = cam.PerspectiveCamera.create((0, 0.5, -3.4), (res, res),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="direct", max_depth=1)
    return scene, camera, cfg
