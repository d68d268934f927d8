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
  192, direct lighting at 512x512;
- ``flagship_setup``: ``bench.py``'s ``bench_flagship``, the mesh bench
  scene checker-textured under a thin-lens camera, stratified 2x2, path/MIS
  at depth 4;
- ``deep512_setup``: ``bench.py``'s ``bench_deep512``, the mesh bench scene
  at path/MIS depth 8;
- ``canonical_setup``, ``canonical_pass`` and ``canonical_render``: the
  canonical frame of ``benchmarks/canonical.py`` (the 872,320-triangle
  dragon stand-in x5 at cap 40 with backface culling, a thin lens, the
  triangle filter and a direct Li that casts no shadow rays).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models.scene import (
    Scene, scene_intersect, texture_from_rgb)
from computational_ray_tracer_tpu_torch.ops import camera as cam
from computational_ray_tracer_tpu_torch.ops import color as colorlib
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops import sensor as sen
from computational_ray_tracer_tpu_torch.ops import spectrum as spec
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


def flagship_setup(res=512, spp=4, scene=None, device="cuda"):
    """``bench.py``'s ``bench_flagship``: the mesh bench scene (``scene``, a
    built ``mesh327k_setup`` scene, is reused if given) textured with
    ``checker_texture(256)`` on every material; a thin-lens camera (lens
    radius 0.02, focus 3.4); stratified 2x2, which takes spp 4; path/MIS
    at depth 4, gaussian filter of radius 0.5."""
    if spp != 4:
        raise ValueError(f"spp {spp}: the flagship's stratified 2x2 grid "
                         "takes 4 samples per pixel")
    if scene is None:
        scene, _, _ = mesh327k_setup(res, spp, device=device)
    mats = dataclasses.replace(
        scene.materials,
        use_texture=torch.ones_like(scene.materials.use_texture))
    scene = dataclasses.replace(
        scene, materials=mats,
        texture=texture_from_rgb(mesh_gen.checker_texture(256),
                                 scene.device))
    camera = cam.PerspectiveCamera.create(
        (0, 0.5, -3.4), (res, res), fov_y=40.0, look_at=(0, 0, 0),
        lens_radius=0.02, focal_distance=3.4)
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="stratified", spp=spp, xs=2, ys=2),
        integrator="path", max_depth=4, filter_name="gaussian")
    return scene, camera, cfg


def deep512_setup(scene=None, res=512, spp=2, device="cuda"):
    """``bench.py``'s ``bench_deep512``: the mesh bench scene (reused if
    given) under the pinhole bench camera; Sobol, path/MIS at depth 8. The
    bench times its passes at spp 4."""
    if scene is None:
        scene, _, _ = mesh327k_setup(res, spp, device=device)
    camera = cam.PerspectiveCamera.create((0, 0.5, -3.4), (res, res),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="path", max_depth=8)
    return scene, camera, cfg


# The canonical frame: the stand-in scaled x5 and moved to z = 800.
CANONICAL_SCALE = 5.0
CANONICAL_SHIFT = (0.0, -40.0, 800.0)
CANONICAL_LIGHT_WI = (0.0, 0.0, -1.0)


def canonical_scene(cap=40, mesh=None, device="cuda"):
    """``benchmarks/canonical.build_scene``: ``mesh`` (vertices, faces,
    uvs; by default ``dragon_stand_in()``, 872,320 triangles) scaled x5 and
    translated by (0, -40, 800), one gray diffuse material, an octree of
    leaf capacity ``cap`` and backface culling against (0, 0, 1)."""
    v, f, uv = mesh_gen.dragon_stand_in() if mesh is None else mesh
    v = (np.asarray(v, np.float32) * CANONICAL_SCALE
         + np.asarray(CANONICAL_SHIFT, np.float32))
    m = trimod.MeshData.build(v, f, uvs=uv, device=device)
    return Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.5, 0.5, 0.5)}],
        lights=[{"kind": "distant", "direction": (0, 0, 1),
                 "rgb": (1.0, 1.0, 1.0), "scale": 1.0}],
        mesh=(m, np.zeros(m.n_triangles, np.int64)), use_octree=True,
        octree_capacity=cap, backface_cull_dir=(0.0, 0.0, 1.0),
        device=device)


def canonical_view(res, spp):
    """The canonical camera (at the origin looking along +z, fov 45, lens
    radius 50, focus 800) and config (stratified sqrt(spp) x spp/sqrt(spp),
    triangle filter of radius 0.5)."""
    xs = max(int(round(spp ** 0.5)), 1)
    camera = cam.PerspectiveCamera.create(
        (0.0, 0.0, 0.0), (res, res), fov_y=45.0, lens_radius=50.0,
        focal_distance=800.0, look_at=(0.0, 0.0, 800.0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="stratified", spp=spp, xs=xs,
                                    ys=spp // xs),
        integrator="direct", max_depth=1, filter_name="triangle")
    return camera, cfg


def canonical_setup(res=500, spp=100, cap=40, mesh=None, device="cuda"):
    """(scene, camera, cfg) of the canonical frame (``canonical_scene`` and
    ``canonical_view``)."""
    return (canonical_scene(cap, mesh, device),) + canonical_view(res, spp)


def _on(x, device):
    """A copy of a dataclass of tensors on ``device``."""
    return type(x)(**{f.name: getattr(x, f.name).to(device)
                      for f in dataclasses.fields(x)})


@functools.lru_cache(maxsize=4)
def _canonical_spectra(device):
    """The canonical Li's spectra on ``device``: the F1 illuminant, the
    white illuminant and the 0.5 gray albedo."""
    return (spec.DenselySampledSpectrum.from_named("stdillum-F1", device),
            _on(colorlib.RGBIlluminantSpectrum.from_rgb((1.0, 1.0, 1.0)),
                device),
            _on(colorlib.RGBAlbedoSpectrum.from_rgb((0.5, 0.5, 0.5)),
                device))


def canonical_pass(scene, camera, cfg, sensor, sample_idx):
    """One sample pass of the canonical frame (``canonical.make_pass``):
    (rgb (H, W, 3), weight (H, W)). Li at a hit is 0.3 F1(lambda) +
    max(n . (0, 0, -1), 0) white(lambda) gray(lambda); no shadow rays; the
    sensor RGB is clamped to [0, 1]."""
    w, h = cfg.resolution
    dev = scene.device
    pixel, wl, fw, o, d = integ.camera_wavefront(
        camera, cfg, integ.make_filter(cfg), int(sample_idx), dev)
    si, _ = scene_intersect(scene, o, d,
                            torch.full_like(o[..., 0], float("inf")))
    f1, white, gray = _canonical_spectra(str(dev))
    light_wi = torch.tensor(CANONICAL_LIGHT_WI, device=dev)
    cosw = torch.clamp(torch.sum(si.n * light_wi, dim=-1), 0.0, 1.0)
    L = 0.3 * f1(wl.lam) + cosw[..., None] * white(wl.lam) * gray(wl.lam)
    L = torch.where(si.valid[..., None], L, torch.zeros_like(L))
    rgb = torch.clamp(sensor.to_sensor_rgb(L, wl), 0.0, 1.0)
    return rgb.reshape(h, w, 3), fw.reshape(h, w)


@torch.no_grad()
def canonical_render(res=500, spp=100, cap=40, scene=None, device="cuda"):
    """The canonical frame (``canonical.render``): ``spp`` passes
    accumulated into a film and resolved with the default resolve (sRGB
    encode, clip). ``scene`` reuses a built ``canonical_scene``. Returns
    (image (H, W, 3), film)."""
    if scene is None:
        scene = canonical_scene(cap, device=device)
    camera, cfg = canonical_view(res, spp)
    sensor = sen.PixelSensor.create()
    film = filmmod.Film.create((res, res), device=scene.device)
    for i in range(spp):
        rgb, wt = canonical_pass(scene, camera, cfg, sensor, i)
        film = film.add_aligned(rgb, wt)
    return film.resolve(sensor), film
