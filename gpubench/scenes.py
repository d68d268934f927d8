"""A configuration's scene, camera and render settings, built for either
side: the port (``computational_ray_tracer_tpu_torch``) or the frozen
plain copy (``gpubench/reference/crt``). Both get the same host arrays
from the benchmark's own mesh generators; each side builds its own tables,
octree included, from them."""

from __future__ import annotations

import dataclasses
import importlib
import types

import numpy as np

from gpubench import cells

PORT = "computational_ray_tracer_tpu_torch"
REFERENCE = "gpubench.reference.crt"


def namespace(package):
    """The modules the benchmark drives, of ``package`` (PORT or
    REFERENCE)."""
    mod = lambda name: importlib.import_module(f"{package}.{name}")
    return types.SimpleNamespace(
        package=package, entry=mod("entry"),
        integ=mod("models.integrator"), inverse=mod("models.inverse"),
        scene=mod("models.scene"), camera=mod("ops.camera"),
        film=mod("ops.film"), sensor=mod("ops.sensor"),
        triangle=mod("ops.triangle"), octree=mod("ops.octree"))


def mesh_arrays(config):
    """(positions, faces, uvs, per-triangle material ids or None) of the
    configuration's mesh: its generator's output, scaled and translated as
    the configuration says (in float32, as the reference's set-up does)."""
    spec = config["mesh"]
    pos, idx, uv, tri_mat = cells.mesh_generator(spec["generator"]).generate(
        **spec.get("params", {}))
    move = spec.get("transform")
    if move:
        pos = (np.asarray(pos, np.float32) * np.float32(move["scale"])
               + np.asarray(move["translate"], np.float32))
    return (np.asarray(pos, np.float32), np.asarray(idx, np.int32),
            np.asarray(uv, np.float32), tri_mat)


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def materials(config, albedos=None):
    """The configuration's material list; ``albedos`` replaces the RGB
    albedos of the first len(albedos) materials (an inverse job's start)."""
    mats = [_tuples(m) for m in config["materials"]]
    for i, rgb in enumerate(albedos or ()):
        mats[i] = dict(mats[i], albedo_rgb=tuple(float(x) for x in rgb))
    return mats


def build_scene(ns, config, arrays, device, albedos=None):
    """The configuration's Scene of side ``ns`` on ``device``."""
    pos, idx, uv, tri_mat = arrays
    mesh = ns.triangle.MeshData.build(pos, idx, uvs=uv, device=device)
    if tri_mat is None:
        tri_mat = np.zeros(mesh.n_triangles, np.int64)
    accel = config.get("accel", {})
    cull = accel.get("backface_cull_dir")
    return ns.scene.Scene.build(
        materials=materials(config, albedos),
        lights=[_tuples(light) for light in config["lights"]],
        mesh=(mesh, tri_mat), use_octree=accel.get("octree", False),
        octree_capacity=accel.get("capacity"),
        backface_cull_dir=None if cull is None else tuple(cull),
        device=device)


def view(ns, config, cell, focal_distance=None, seed=0):
    """(camera, RenderConfig) of side ``ns``: the configuration's camera and
    render settings, with the cell's ``view`` over them, the focal distance
    ``focal_distance`` (None: the configured one) and the sampler seed
    ``seed``."""
    over = cell.get("view", {})
    cam = dict(config["camera"], **over.get("camera", {}))
    rnd = dict(config["render"], **over.get("render", {}))
    res = tuple(rnd.pop("resolution"))
    spp = rnd.pop("spp")
    kind = rnd.pop("sampler")
    if focal_distance is not None:
        cam["focal_distance"] = float(focal_distance)
    eye = tuple(cam.pop("eye"))
    camera = ns.camera.PerspectiveCamera.create(eye, res, **_tuples(cam))
    sampler = ns.integ.SamplerConfig(kind=kind, spp=spp, seed=int(seed))
    if kind == "stratified":
        xs = max(int(round(spp ** 0.5)), 1)
        sampler = dataclasses.replace(sampler, xs=xs, ys=spp // xs)
    return camera, ns.integ.RenderConfig(resolution=res, sampler=sampler,
                                         **rnd)
