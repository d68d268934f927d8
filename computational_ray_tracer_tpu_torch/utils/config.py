"""Scenes as data (``computational_ray_tracer_tpu/utils/config.py``): a
declarative dict or JSON file that assembles a Scene, a camera and a
RenderConfig.

A spec holds ``render`` (RenderConfig and SamplerConfig fields), ``camera``
(a kind of ``CAMERA_KINDS`` and its create arguments), ``materials``,
``lights``, ``shapes`` (``sphere``, ``cylinder`` and ``disk`` with an
optional ``transform``; ``cornell_box``, ``box``, ``mesh_obj`` and
``uv_sphere``, merged into one triangle mesh), an optional ``texture``
(``checker`` or ``image``), ``use_octree`` (default True) and
``backface_cull_dir``. The defaults are the reference's.
"""

from __future__ import annotations

import json

import numpy as np

from computational_ray_tracer_tpu_torch.models.scene import Scene
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.ops import camera as cam
from computational_ray_tracer_tpu_torch.ops import shapes as shp
from computational_ray_tracer_tpu_torch.ops import triangle as trimod
from computational_ray_tracer_tpu_torch.utils import mesh_gen, obj_loader

CAMERA_KINDS = {
    "perspective": cam.PerspectiveCamera,
    "orthographic": cam.OrthographicCamera,
    "pinhole": cam.PinholeCamera,
    "thinlens": cam.ThinLensCamera,
}


def _build_transform(spec):
    if spec is None:
        return None
    return shp.make_transform(
        translate=tuple(spec.get("translate", (0, 0, 0))),
        rotate_deg=tuple(spec.get("rotate_deg", (0, 0, 0))),
        scale=spec.get("scale", 1.0))


def build_camera(spec, resolution):
    kind = spec.get("kind", "perspective")
    kwargs = {k: v for k, v in spec.items() if k != "kind"}
    for key in ("position", "look_at", "window", "sensor_size"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    return CAMERA_KINDS[kind].create(resolution=tuple(resolution), **kwargs)


def build_render_config(spec):
    s = spec.get("sampler", {})
    sampler = integ.SamplerConfig(
        kind=s.get("kind", "sobol"), spp=s.get("spp", 16),
        xs=s.get("xs", 4), ys=s.get("ys", 4), seed=s.get("seed", 0),
        jitter=s.get("jitter", True))
    return integ.RenderConfig(
        resolution=tuple(spec.get("resolution", (256, 256))),
        sampler=sampler,
        integrator=spec.get("integrator", "path"),
        max_depth=spec.get("max_depth", 5),
        rr_start=spec.get("rr_start", 3),
        lambda_mode=spec.get("lambda_mode", "visible"),
        filter_name=spec.get("filter", "gaussian"),
        filter_radius=tuple(spec.get("filter_radius", (0.5, 0.5))),
        sensor_name=spec.get("sensor"),
        clamp=spec.get("clamp", 0.0))


def _mesh_part(kind, body):
    """(positions, indices, uvs, per-triangle materials) of a mesh shape."""
    one = lambda idx: np.full(len(idx), body.get("material", 0), np.int32)
    if kind == "cornell_box":
        pos, idx, uv, mats, _ = mesh_gen.cornell_box(
            body.get("size", 2.0), body.get("light_frac", 0.5))
        return pos, idx, uv, np.asarray(mats) + body.get("material_base", 0)
    if kind == "box":
        pos, idx, uv = mesh_gen.box(tuple(body["lo"]), tuple(body["hi"]))
    elif kind == "mesh_obj":
        pos, idx, _, uv = obj_loader.load_obj(body["path"])
    elif kind == "uv_sphere":
        pos, idx, uv = mesh_gen.uv_sphere(
            tuple(body.get("center", (0, 0, 0))), body.get("radius", 1.0))
    else:
        raise ValueError(f"unknown shape kind {kind!r}")
    return pos, idx, uv, one(idx)


def build_scene(spec, device="cuda"):
    """Assemble a Scene on ``device`` from a declarative dict."""
    shapes = {"spheres": [], "cylinders": [], "disks": []}
    mesh_parts = []
    for sh in spec.get("shapes", []):
        kind = sh["kind"]
        body = {k: v for k, v in sh.items() if k != "kind"}
        if "transform" in body:
            body["transform"] = _build_transform(body["transform"])
        if kind in ("sphere", "cylinder", "disk"):
            shapes[kind + "s"].append(body)
        else:
            mesh_parts.append(_mesh_part(kind, body))

    mesh = None
    if mesh_parts:
        pos, idx, uv, _ = mesh_gen.merge_meshes(
            [(p, i, u) for (p, i, u, _) in mesh_parts])
        tri_mats = np.concatenate([m for (_, _, _, m) in mesh_parts])
        mesh = (trimod.MeshData.build(pos, idx, uvs=uv, device=device),
                tri_mats)

    texture = None
    t = spec.get("texture", {})
    if t.get("kind") == "checker":
        texture = mesh_gen.checker_texture(
            t.get("res", 64), tuple(t.get("c0", (0.9, 0.9, 0.9))),
            tuple(t.get("c1", (0.15, 0.15, 0.55))))
    elif t.get("kind") == "image":
        from computational_ray_tracer_tpu_torch.utils import image
        texture = image.read_image(t["path"])

    return Scene.build(
        materials=spec["materials"],
        lights=spec.get("lights", []),
        spheres=shapes["spheres"] or None,
        cylinders=shapes["cylinders"] or None,
        disks=shapes["disks"] or None,
        mesh=mesh,
        use_octree=spec.get("use_octree", True),
        texture_rgb=texture,
        backface_cull_dir=spec.get("backface_cull_dir"),
        device=device)


def load_scene_file(path, device="cuda"):
    """(scene on ``device``, camera, render config) of a JSON scene file."""
    with open(path) as f:
        spec = json.load(f)
    render_cfg = build_render_config(spec.get("render", {}))
    camera = build_camera(spec.get("camera", {"position": (0, 0, -4),
                                              "look_at": (0, 0, 0)}),
                          render_cfg.resolution)
    return build_scene(spec, device), camera, render_cfg
