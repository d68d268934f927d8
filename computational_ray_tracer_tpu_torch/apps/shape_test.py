"""Shape test app (``computational_ray_tracer_tpu/apps/shape_test.py``):
render every shape kind with normal and uv false colour, compare the
octree with the brute force, report the triangle-test counters.

``triangle_tests_total`` sums ``scene_intersect(..., stats=True)``'s
count: F a ray for the brute force; for the octree, on the card the
kernel's ``tests`` counter (its near-to-far sibling-group walk, as the
reference's Pallas kernel counts on a TPU), on the CPU the plain lockstep
traversal's (as the reference's jnp traversal counts on a CPU). The two
octree counts differ.
"""

from __future__ import annotations

import json
import os

import numpy as np


def shape_scenes(device="cuda"):
    """{name: Scene}: the clipped sphere, the cylinder, the annular disk,
    and the 2,208-triangle uv sphere in an octree and in brute force."""
    import torch
    from computational_ray_tracer_tpu_torch.models.scene import Scene
    from computational_ray_tracer_tpu_torch.ops import shapes as shp
    from computational_ray_tracer_tpu_torch.ops import triangle as trimod
    from computational_ray_tracer_tpu_torch.utils import mesh_gen

    mats = [{"kind": "diffuse", "albedo_rgb": (0.7, 0.7, 0.7)}]
    lights = [{"kind": "ambient", "spd_named": "stdillum-E", "scale": 1.0}]
    build = lambda **kw: Scene.build(mats, lights, device=device, **kw)
    scenes = {
        "sphere": build(spheres=[
            {"radius": 1.0, "z_min": -0.8, "z_max": 0.9,
             "phi_max": 5.5, "material": 0}]),
        "cylinder": build(cylinders=[
            {"radius": 0.7, "z_min": -1.0, "z_max": 1.0, "material": 0,
             "transform": shp.make_transform(rotate_deg=(90, 0, 0))}]),
        "disk": build(disks=[
            {"radius": 1.2, "inner_radius": 0.3, "material": 0,
             "transform": shp.make_transform(rotate_deg=(25, 0, 0))}]),
    }
    pos, idx, uv = mesh_gen.uv_sphere((0, 0, 0), 1.0, 24, 48)
    mesh = trimod.MeshData.build(pos, idx, uvs=uv, device=device)
    tri_mat = torch.zeros(mesh.n_triangles, dtype=torch.int64)
    scenes["mesh_octree"] = build(mesh=(mesh, tri_mat), use_octree=True)
    scenes["mesh_brute"] = build(mesh=(mesh, tri_mat), use_octree=False)
    return scenes


def camera_rays(res, device="cuda"):
    """The app's camera and its pixel-centre rays (o, d), (res^2, 3)."""
    import torch
    from computational_ray_tracer_tpu_torch.ops import camera as cam
    camera = cam.PerspectiveCamera.create((0, 0.6, -3.2), (res, res),
                                          fov_y=45.0, look_at=(0, 0, 0))
    i = torch.arange(res * res, device=device)
    pp = torch.stack([i % res + 0.5, i // res + 0.5], -1).to(torch.float32)
    return camera.generate_rays(pp, torch.full((res * res, 2), 0.5,
                                               device=device))


def shade(scene, o, d):
    """(normal false colour (N, 3), uv false colour (N, 3), hit mask, t,
    triangle tests) of the camera rays o/d in ``scene``."""
    import torch
    from computational_ray_tracer_tpu_torch.models.scene import (
        scene_intersect)
    t_max = torch.full(o.shape[:-1], float("inf"), device=o.device)
    si, _, tests = scene_intersect(scene, o, d, t_max, stats=True)
    valid = si.valid[:, None]
    uvs = torch.where(valid, si.uv, 0.0)
    return (torch.where(valid, (si.n + 1.0) / 2.0, 0.0),
            torch.cat([uvs, torch.zeros_like(uvs[:, :1])], -1), si.valid,
            si.t, tests)


def main(outdir="out", res=128, device="cuda"):
    """Write ``<shape>_normals.png``, ``<shape>_uv.png`` and
    ``shape_test.json`` into ``outdir``; returns the report dict."""
    from computational_ray_tracer_tpu_torch.utils import image

    os.makedirs(outdir, exist_ok=True)
    o, d = camera_rays(res, device)
    report, hits = {}, {}
    for name, scene in shape_scenes(device).items():
        normal_img, uv_img, valid, t, tests = shade(scene, o, d)
        image.write_png(os.path.join(outdir, f"{name}_normals.png"),
                        normal_img.reshape(res, res, 3))
        image.write_png(os.path.join(outdir, f"{name}_uv.png"),
                        uv_img.reshape(res, res, 3))
        v = valid.cpu().numpy()
        hits[name] = (v, t.cpu().numpy())
        report[name] = {
            "hit_fraction": float(v.mean()),
            "triangle_tests_total": int(tests.sum()),
        }
        if scene.octree is not None:
            report[name]["octree"] = scene.octree.info()

    # octree and brute force must give the same hits
    (vo, to), (vb, tb) = hits["mesh_octree"], hits["mesh_brute"]
    report["octree_matches_brute"] = bool(
        np.array_equal(vo, vb) and np.allclose(to[vo], tb[vb], rtol=1e-4))
    report["octree_speedup_tests"] = (
        report["mesh_brute"]["triangle_tests_total"]
        / max(report["mesh_octree"]["triangle_tests_total"], 1))

    with open(os.path.join(outdir, "shape_test.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report
