"""Where one pass of one of the port's headline renders spends its device
time, eager and as a replay of a captured CUDA graph.

    python tools/profile_torch_pass.py
        [--scene cornell|mesh327k|flagship|deep512|canonical ...]
        [--train] [--res N] [--reps 5] [--out DIR]

Runs the Cornell headline scene (``--scene cornell``, the default:
``computational_ray_tracer_tpu_torch.entry.cornell_setup``, path/MIS depth
4), the mesh bench scene (``mesh327k``: ``entry.mesh327k_setup``, 327,680
triangles in an octree, direct lighting), the flagship (``flagship``:
``entry.flagship_setup``, the mesh bench scene textured, path/MIS depth
4) or deep512 (``deep512``: ``entry.deep512_setup``, path/MIS depth 8) on
the GPU through ``render_pass``, the pass ``render()`` runs; or the
canonical frame (``canonical``: ``entry.canonical_setup``, the
872,320-triangle stand-in at leaf cap 40, culled, through
``entry.canonical_pass``, the pass ``canonical_render`` runs; ``--res``
500 is its size). Each scene named, in one process: one warm-up pass,
then each side in turn, first the eager pass, then the pass captured in an
``integrator.pass_graph`` and replayed (``render()``'s route on the card):
``--reps`` unprofiled passes, each timed on the host clock from its start
to a ``synchronize`` (the pass's wall time); one pass under
``torch.profiler`` with CPU and CUDA activities, whose kernel durations
give the pass's device busy time; one pass timed by CUDA events. The
device idle share of an unprofiled pass is 1 - busy time / median
unprofiled wall time (the profiler stretches wall time, not kernel
durations). Prints one JSON line a scene with each side's numbers (the
share of the port's own kernels, mesh intersection, octree traversal,
dense-spectrum interpolation, in the busy time, the launch count and the
top device kernels) and the capture's seconds, and writes the same JSON
and each side's chrome trace to ``--out`` (by default the package's
git-ignored build directory), named after the scene. Needs a CUDA card;
imports nothing of JAX.

``--train`` profiles one training step of BASELINE config 5 instead
(``entry.config5_setup("full")``: 48x48, Sobol spp 8, path/MIS depth 3,
every leaf of ``inverse.albedo_and_emission_params``; the step
``inverse.optimize`` runs on the card: zero the gradients, the 8 passes and
the MSE, the backward, ``inverse.DeviceAdam``), in the same two sides: the
eager step, then the step captured in a ``graphs.CapturedGraph`` and
replayed; the row also carries the kernel wrappers' launches a step and
the share of the interpolation backward kernel. Its files are named
``config5_train``.
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
from computational_ray_tracer_tpu_torch.models import graphs  # noqa: E402
from computational_ray_tracer_tpu_torch.models import (  # noqa: E402
    integrator as integ)
from computational_ray_tracer_tpu_torch.models import (  # noqa: E402
    inverse as inv)
from computational_ray_tracer_tpu_torch.ops import sensor as sen  # noqa: E402

SCENES = ("cornell", "mesh327k", "flagship", "deep512", "canonical")


def kernel_times(prof):
    """{kernel name: [device microseconds, launches]} of a profile."""
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total
            k[1] += 1
    return kernels


def measure(run, reps):
    """``reps`` unprofiled runs of ``run`` (one pass each), host-timed to a
    synchronize, then one profiled run and one timed by CUDA events: the
    row of one side (eager or graph)."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    e1.synchronize()
    kernels = kernel_times(prof)
    busy_s = sum(v[0] for v in kernels.values()) * 1e-6
    share = lambda key: sum(v[0] for n, v in kernels.items()
                            if key in n) * 1e-6 / max(busy_s, 1e-12)
    wall = statistics.median(walls)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return prof, {
        "unprofiled_wall_s": walls, "unprofiled_wall_median_s": wall,
        "profiled_wall_s": profiled_wall, "event_ms": e0.elapsed_time(e1),
        "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall if busy_s > 0 else None,
        "mesh_kernel_share_of_busy": share("mesh_intersect"),
        # The octree wrapper's two kernels: the live-ray queue and the
        # traversal (one launch of each per wrapper call).
        "octree_kernel_share_of_busy": share("octree_"),
        "octree_kernel_busy_s": share("octree_") * busy_s,
        "octree_kernel_launches": sum(v[1] for n, v in kernels.items()
                                      if "octree_traverse" in n),
        "interp_kernel_share_of_busy": share("dense_interp"),
        "interp_backward_share_of_busy": share("dense_interp_backward"),
        "n_kernel_launches": sum(v[1] for v in kernels.values()),
        "top": [{"name": n[:90], "us": v[0], "count": v[1]}
                for n, v in top]}


def setup(name, res, dev):
    """(one_pass(i), resolution) of a scene."""
    if name == "cornell":
        scene, camera, cfg = entry.cornell_setup(res, 32, dev)
    elif name == "mesh327k":
        scene, camera, cfg = entry.mesh327k_setup(res, 4, device=dev)
    elif name == "flagship":
        scene, camera, cfg = entry.flagship_setup(res, 4, device=dev)
    elif name == "deep512":
        scene, camera, cfg = entry.deep512_setup(res=res, device=dev)
    else:
        scene, camera, cfg = entry.canonical_setup(res, device=dev)
    sensor = sen.PixelSensor.create()
    if name == "canonical":
        return (lambda i: entry.canonical_pass(scene, camera, cfg, sensor,
                                               i)), cfg.resolution
    flt = integ.make_filter(cfg)
    return (lambda i: integ.render_pass(scene, camera, cfg, flt, sensor,
                                        i)), cfg.resolution


def profile_train(reps, out, dev):
    """The --train row: one config 5 step, eager, then replayed."""
    target, start, camera, cfg, lr, _ = entry.config5_setup("full", dev)
    render_image, _ = inv.make_render_fn(camera, cfg)
    with torch.no_grad():
        target_img = render_image(target)
    ei = inv.albedo_and_emission_params(start)
    params = inv.leaf_params(ei[0](start))
    opt = inv.DeviceAdam(list(params.values()), lr)
    step = inv.make_step(camera, cfg, ei, target_img, params, start, opt)
    graphs.on_side_stream(step)
    before = graphs.launch_counts()
    step()
    launches = {k: n - before[k] for k, n in graphs.launch_counts().items()}
    prof, eager = measure(step, reps)
    prof.export_chrome_trace(os.path.join(out, "config5_train_trace.json"))
    opt.zero_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = graphs.CapturedGraph(step)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    prof, replay = measure(graph.replay, reps)
    prof.export_chrome_trace(os.path.join(out,
                                          "config5_train_graph_trace.json"))
    assert graph.launches == launches, (graph.launches, launches)
    return {"scene": "config5_train", "res": cfg.resolution[0],
            "spp": cfg.sampler.spp, "depth": cfg.max_depth,
            "wrapper_launches_per_step": launches, "eager": eager,
            "graph": {**replay, "capture_s": capture_s},
            "card": torch.cuda.get_device_name(0)}


def emit(row, out):
    """Write ``row`` to ``out``/<scene>_profile.json and print it."""
    with open(os.path.join(out, f"{row['scene']}_profile.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", nargs="+", choices=SCENES, default=None,
                    help="default: cornell, unless --train is given")
    ap.add_argument("--train", action="store_true",
                    help="profile one config 5 training step")
    ap.add_argument("--res", type=int, default=None,
                    help="image side (default 500 for canonical, else 512)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out",
                    default="computational_ray_tracer_tpu_torch/build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_pass.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    os.makedirs(args.out, exist_ok=True)
    if args.train:
        emit(profile_train(args.reps, args.out, dev), args.out)
    for name in args.scene or ([] if args.train else ["cornell"]):
        res = args.res or (500 if name == "canonical" else 512)
        one_pass, resolution = setup(name, res, dev)
        with torch.no_grad():
            one_pass(0)
            prof, eager = measure(lambda: one_pass(1), args.reps)
            prof.export_chrome_trace(os.path.join(args.out,
                                                  f"{name}_trace.json"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = integ.pass_graph(one_pass, 1, resolution, dev)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            prof, replay = measure(lambda: integ.replay_sums(graph, 1),
                                   args.reps)
            prof.export_chrome_trace(os.path.join(
                args.out, f"{name}_graph_trace.json"))
        del graph
        torch.cuda.empty_cache()
        emit({"scene": name, "res": res, "eager": eager,
              "graph": {**replay, "capture_s": capture_s},
              "card": torch.cuda.get_device_name(0)}, args.out)


if __name__ == "__main__":
    main()
