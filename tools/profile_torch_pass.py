"""Where one pass of one of the port's headline renders spends its device
time.

    python tools/profile_torch_pass.py [--scene cornell|mesh327k|flagship]
        [--res 512] [--reps 5] [--out DIR]

Runs the Cornell headline scene (``--scene cornell``, the default:
``computational_ray_tracer_tpu_torch.entry.cornell_setup``, path/MIS depth
4), the mesh bench scene (``--scene mesh327k``: ``entry.mesh327k_setup``,
327,680 triangles in an octree, direct lighting) or the flagship
(``--scene flagship``: ``entry.flagship_setup``, the mesh bench scene
textured, path/MIS depth 4) on the GPU through ``render_pass``, the pass
``render()`` runs, all in one process on one tree: one warm-up pass;
``--reps`` unprofiled passes, each timed on the host clock from its
start to a ``synchronize`` (the pass's wall time); then one pass under
``torch.profiler`` with CPU and CUDA activities, whose kernel durations give
the pass's device busy time. The device idle share of an unprofiled pass is
1 - busy time / median unprofiled wall time (the profiler stretches wall
time, not kernel durations). Prints one JSON line with those numbers, the
share of the port's own kernels (mesh intersection, octree traversal,
dense-spectrum interpolation) in
the busy time, the launch count and the top device kernels, and writes the
same JSON and the chrome trace to ``--out`` (by default the package's
git-ignored build directory), named after the scene. Needs a CUDA card;
imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from computational_ray_tracer_tpu_torch import entry  # noqa: E402
from computational_ray_tracer_tpu_torch.models import (  # noqa: E402
    integrator as integ)
from computational_ray_tracer_tpu_torch.ops import sensor as sen  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("cornell", "mesh327k", "flagship"),
                    default="cornell")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out",
                    default="computational_ray_tracer_tpu_torch/build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_pass.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.scene == "cornell":
        scene, camera, cfg = entry.cornell_setup(args.res, 32, dev)
    elif args.scene == "mesh327k":
        scene, camera, cfg = entry.mesh327k_setup(args.res, 4, device=dev)
    else:
        scene, camera, cfg = entry.flagship_setup(args.res, 4, device=dev)
    flt, sensor = integ.make_filter(cfg), sen.PixelSensor.create()
    walls = []
    with torch.no_grad():
        integ.render_pass(scene, camera, cfg, flt, sensor, 0)
        torch.cuda.synchronize()
        for i in range(args.reps):
            t0 = time.perf_counter()
            integ.render_pass(scene, camera, cfg, flt, sensor, 1 + i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            integ.render_pass(scene, camera, cfg, flt, sensor, 1)
            torch.cuda.synchronize()
            profiled_wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total
            k[1] += 1
    busy_s = sum(v[0] for v in kernels.values()) * 1e-6
    share = lambda key: sum(v[0] for n, v in kernels.items()
                            if key in n) * 1e-6 / max(busy_s, 1e-12)
    wall = statistics.median(walls)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    row = {
        "scene": args.scene, "res": args.res, "unprofiled_wall_s": walls,
        "unprofiled_wall_median_s": wall, "profiled_wall_s": profiled_wall,
        "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall,
        "mesh_kernel_share_of_busy": share("mesh_intersect"),
        "octree_kernel_share_of_busy": share("octree_traverse"),
        "interp_kernel_share_of_busy": share("dense_interp"),
        "n_kernel_launches": sum(v[1] for v in kernels.values()),
        "top": [{"name": n[:90], "us": v[0], "count": v[1]}
                for n, v in top]}
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"{args.scene}_trace.json"))
    with open(os.path.join(args.out, f"{args.scene}_profile.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
