"""The port's scenes, each as (scene, camera, cfg) on ``device`` (the card
by default):

- ``cornell_setup``: the Cornell box of ``__graft_entry__._cornell_setup``
  (12-triangle box + light quad, a metal-Ag conductor sphere, one quad
  light; Sobol sampler, path/MIS at depth 4, gaussian filter, XYZ sensor),
  in the brute-force mesh configuration;
- ``golden1_sphere_direct``, ``golden2_cornell_path`` and
  ``golden3_mesh_octree_textured``: golden configurations 1-3 of
  ``tests/test_golden.py``;
- ``config5_setup`` and ``config5_reflectance_mae``: the inverse-rendering
  task of ``benchmarks/run_configs.py`` ``config5_inverse`` (recover the
  Cornell box's albedos from a target image);
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
  triangle filter and a direct Li that casts no shadow rays);
- ``shapes_setup``: the clipped sphere, the cylinder and the annular disk
  of ``apps/shape_test.py`` under an ambient light, seen by any of the four
  camera kinds, direct lighting.
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
from computational_ray_tracer_tpu_torch.ops import spectra_data as data
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


def golden1_sphere_direct(device="cuda"):
    """The golden-image configuration 1 of ``tests/test_golden.py``: a
    diffuse sphere under a point light, direct lighting, stratified 2x2 at
    32x32."""
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.6, 0.3, 0.25)}],
        lights=[{"kind": "point", "position": (3.0, 4.0, -3.0),
                 "rgb": (1.0, 1.0, 1.0), "scale": 50.0}],
        spheres=[{"radius": 1.0, "transform": shp.make_transform((0, 0, 0)),
                  "material": 0}], device=device)
    camera = cam.PerspectiveCamera.create((0, 0, -4), (32, 32), fov_y=40.0,
                                          look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(32, 32),
        sampler=integ.SamplerConfig(kind="stratified", spp=4, xs=2, ys=2),
        integrator="direct", max_depth=1)
    return scene, camera, cfg


def golden2_cornell_path(res=32, spp=4, device="cuda"):
    """The golden-image configuration 2 of ``tests/test_golden.py``: the
    Cornell box without the sphere, rendered at depth 4 with Sobol."""
    scene_args, camera, cfg = _cornell_box(res, spp, device)
    return Scene.build(materials=CORNELL_MATERIALS, **scene_args), camera, cfg


# A sphere of each kind of models/materials.py for material_kinds_setup.
KIND_MATERIALS = [
    {"kind": "diffuse", "albedo_rgb": (0.7, 0.2, 0.1), "use_texture": True},
    {"kind": "conductor", "albedo_rgb": (1.0, 1.0, 1.0), "metal": "metal-Au"},
    {"kind": "dielectric", "albedo_rgb": (1.0, 1.0, 1.0),
     "glass": "glass-BK7"},
    {"kind": "rough_conductor", "albedo_rgb": (0.9, 0.8, 0.7),
     "metal": "metal-Cu", "roughness": 0.3}]
KIND_SPHERES = ((-0.45, -0.6, 0.3), (0.45, -0.6, 0.3), (-0.4, 0.2, -0.2),
                (0.4, 0.1, 0.1))
# The lights material_kinds_setup names; "quad" is the box's own.
KIND_LIGHTS = {
    "point": {"kind": "point", "position": (0.3, 0.7, -0.2), "scale": 2.0},
    "distant": {"kind": "distant", "direction": (-0.3, -1.0, 0.4),
                "rgb": (1.0, 0.9, 0.8)},
    "ambient": {"kind": "ambient", "spd_named": "stdillum-D65",
                "scale": 0.3}}


def material_kinds_setup(res=512, lights=("distant", "quad"), texture=True,
                         integrator="path", max_depth=5, device="cuda"):
    """The Cornell box with a 0.3 m sphere of each material kind
    (Lambertian, a gold conductor, a BK7 dielectric, which disperses, and
    rough copper) under the ``lights`` named in ``KIND_LIGHTS`` (and
    "quad", the box's light); with ``texture`` the left wall and the
    Lambertian sphere are checker-textured (``checker_texture(16)``).
    Sobol spp 4, ``integrator`` at ``max_depth`` with roulette from depth
    2, so that a pass bounces past it."""
    pos, idx, uv, mats, quad = mesh_gen.cornell_box(2.0)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv, device=device)
    n0 = len(CORNELL_MATERIALS)
    spheres = [{"radius": 0.3, "transform": shp.make_transform(c),
                "material": n0 + k} for k, c in enumerate(KIND_SPHERES)]
    named = dict(KIND_LIGHTS, quad=cornell_light(*quad))
    scene = Scene.build(
        materials=CORNELL_MATERIALS + KIND_MATERIALS,
        lights=[named[name] for name in lights], spheres=spheres,
        mesh=(mesh, np.where(np.asarray(mats) == 1, n0, mats)),
        use_octree=False,
        texture_rgb=mesh_gen.checker_texture(16) if texture else None,
        device=device)
    camera = cam.PerspectiveCamera.create((0, 0, -2.8), (res, res),
                                          fov_y=50.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=4),
        integrator=integrator, max_depth=max_depth, rr_start=2)
    return scene, camera, cfg


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


CONFIG5_TARGET = [(0.73, 0.73, 0.73), (0.65, 0.05, 0.05), (0.12, 0.45, 0.15)]
CONFIG5_START = [(0.4, 0.4, 0.4), (0.3, 0.3, 0.3), (0.3, 0.3, 0.3)]


def config5_setup(scale="full", device="cuda"):
    """``benchmarks/run_configs.py`` ``config5_inverse``: the Cornell box
    (brute mesh, one quad light) built with the target albedos and with the
    start albedos. Full scale: 48x48, Sobol spp 8, path/MIS depth 3, fov
    70 from z = -2.2 inside the box (both coloured walls in view), Adam at
    lr 0.1 for 300 steps; small scale: 32x32, spp 4, fov 50 from z = -2.8,
    lr 0.05, 25 steps. Returns (target_scene, start_scene, camera, cfg, lr,
    steps)."""
    full = scale == "full"
    res, spp = (48, 8) if full else (32, 4)
    pos, idx, uv, mats, light = mesh_gen.cornell_box(2.0)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv, device=device)

    def build(albedos):
        return Scene.build(
            materials=[{"kind": "diffuse", "albedo_rgb": a} for a in albedos]
            + CORNELL_MATERIALS[3:], lights=[cornell_light(*light)],
            mesh=(mesh, mats), use_octree=False, device=device)

    camera = cam.PerspectiveCamera.create(
        (0, 0, -2.2 if full else -2.8), (res, res),
        fov_y=70.0 if full else 50.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=spp),
        integrator="path", max_depth=3)
    return (build(CONFIG5_TARGET), build(CONFIG5_START), camera, cfg,
            0.1 if full else 5e-2, 300 if full else 25)


def config5_reflectance_mae(params, target_scene):
    """The recovery metric of ``config5_inverse``: for each of the three
    wall materials, the mean |recovered - target| reflectance over the
    1 nm grid weighted by the visible-wavelength sampling pdf (the
    distribution the renderer observes). Returns the three values."""
    lam = torch.as_tensor(data.DENSE_LAMBDA.astype(np.float32))
    refl = lambda c: colorlib.sigmoid_polynomial(
        c.detach().cpu()[:3, None, :], lam[None, :])[:, 0, :]
    w = spec.visible_wavelengths_pdf(lam)
    w = w / torch.sum(w)
    err = torch.abs(refl(params["albedo_coeffs"])
                    - refl(target_scene.materials.albedo_coeffs))
    return [float(x) for x in torch.sum(err * w[None, :], dim=-1)]


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
    """The canonical Li's constants on ``device``: the F1 illuminant, the
    white illuminant, the 0.5 gray albedo and the light direction."""
    return (spec.DenselySampledSpectrum.from_named("stdillum-F1", device),
            _on(colorlib.RGBIlluminantSpectrum.from_rgb((1.0, 1.0, 1.0)),
                device),
            _on(colorlib.RGBAlbedoSpectrum.from_rgb((0.5, 0.5, 0.5)),
                device),
            torch.tensor(CANONICAL_LIGHT_WI, device=device))


def canonical_pass(scene, camera, cfg, sensor, sample_idx):
    """One sample pass of the canonical frame (``canonical.make_pass``):
    (rgb (H, W, 3), weight (H, W)). Li at a hit is 0.3 F1(lambda) +
    max(n . (0, 0, -1), 0) white(lambda) gray(lambda); no shadow rays; the
    sensor RGB is clamped to [0, 1]. ``sample_idx``: a Python int or a 0-d
    integer tensor on the scene's device (the same values)."""
    w, h = cfg.resolution
    dev = scene.device
    pixel, wl, fw, o, d = integ.camera_wavefront(
        camera, cfg, integ.make_filter(cfg),
        integ.sample_index(sample_idx, dev), dev)
    si, _, _ = scene_intersect(scene, o, d,
                               torch.full_like(o[..., 0], float("inf")))
    f1, white, gray, light_wi = _canonical_spectra(str(dev))
    cosw = torch.clamp(torch.sum(si.n * light_wi, dim=-1), 0.0, 1.0)
    L = 0.3 * f1(wl.lam) + cosw[..., None] * white(wl.lam) * gray(wl.lam)
    L = torch.where(si.valid[..., None], L, torch.zeros_like(L))
    rgb = torch.clamp(sensor.to_sensor_rgb(L, wl), 0.0, 1.0)
    return rgb.reshape(h, w, 3), fw.reshape(h, w)


@torch.no_grad()
def canonical_render(res=500, spp=100, cap=40, scene=None, device="cuda"):
    """The canonical frame (``canonical.render``): ``spp`` passes
    accumulated into a film and resolved with the default resolve (sRGB
    encode, clip). ``scene`` reuses a built ``canonical_scene``. On a CUDA
    scene every pass after the first is a replay of one captured CUDA graph
    (``integrator.pass_graph``; the same bits as the eager loop). Returns
    (image (H, W, 3), film)."""
    if scene is None:
        scene = canonical_scene(cap, device=device)
    camera, cfg = canonical_view(res, spp)
    sensor = sen.PixelSensor.create()
    film = integ.accumulate(
        lambda i: canonical_pass(scene, camera, cfg, sensor, i),
        filmmod.Film.create((res, res), device=scene.device), spp,
        capture=scene.device.type == "cuda")
    return film.resolve(sensor), film


SHAPE_MATERIALS = [{"kind": "diffuse", "albedo_rgb": (0.7, 0.7, 0.7)}]
SHAPE_LIGHTS = [{"kind": "ambient", "spd_named": "stdillum-E", "scale": 1.0}]
SHAPE_EYE = (0.0, 0.6, -3.2)
# Each camera kind's class name and parameters, from SHAPE_EYE looking at
# the origin; the lens cameras' sensors are sized to frame the shapes.
SHAPE_CAMERAS = {
    "perspective": ("PerspectiveCamera", {"fov_y": 45.0}),
    "orthographic": ("OrthographicCamera", {"window": (3.0, 3.0)}),
    "pinhole": ("PinholeCamera", {"sensor_size": (0.05, 0.05),
                                  "sensor_distance": 0.05,
                                  "hole_radius": 0.002}),
    "thinlens": ("ThinLensCamera", {"sensor_size": (0.5, 0.5),
                                    "aperture_radius": 0.02,
                                    "focus_distance": 3.25}),
}


def shape_items(kind):
    """The Scene.build shape argument of ``apps/shape_test.py``'s scene
    ``kind``: a clipped sphere, a cylinder turned 90 degrees about x, or an
    annular disk tilted 25 degrees."""
    return {
        "sphere": {"spheres": [{"radius": 1.0, "z_min": -0.8, "z_max": 0.9,
                                "phi_max": 5.5, "material": 0}]},
        "cylinder": {"cylinders": [{
            "radius": 0.7, "z_min": -1.0, "z_max": 1.0, "material": 0,
            "transform": shp.make_transform(rotate_deg=(90, 0, 0))}]},
        "disk": {"disks": [{
            "radius": 1.2, "inner_radius": 0.3, "material": 0,
            "transform": shp.make_transform(rotate_deg=(25, 0, 0))}]},
    }[kind]


def shapes_setup(kind, camera_kind, res, device="cuda"):
    """(scene, camera, cfg): the ``shape_items(kind)`` scene (one diffuse
    material, an equal-energy ambient light) seen from SHAPE_EYE by the
    ``camera_kind`` camera of SHAPE_CAMERAS; Sobol spp 4, direct lighting
    at res x res."""
    scene = Scene.build(SHAPE_MATERIALS, SHAPE_LIGHTS, device=device,
                        **shape_items(kind))
    name, kw = SHAPE_CAMERAS[camera_kind]
    camera = getattr(cam, name).create(SHAPE_EYE, (res, res),
                                       look_at=(0.0, 0.0, 0.0), **kw)
    cfg = integ.RenderConfig(
        resolution=(res, res),
        sampler=integ.SamplerConfig(kind="sobol", spp=4),
        integrator="direct", max_depth=1)
    return scene, camera, cfg
