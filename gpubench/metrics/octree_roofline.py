"""octree_roofline: the least time of one closest-hit octree launch of the
profiled frame over the kernel's profiled device time per launch, in %.

The least time is the larger of two bounds (``roofline``): the operations
of every triangle test and slab test at 67 TFLOP/s, and the bytes at
3.35 TB/s. Both count from the benchmark's frozen plain traversal
(``reference/crt/ops/octree.py``, with node pops) of the profiled frame's
first pass of camera rays over the reference's own tree, never from the
kernel's counters. The kernel's time is that of ``octree_live_rays`` and
``octree_traverse_kernel<false>`` per closest-hit launch."""

import math

import torch

from gpubench import roofline, scenes

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["canonical.frames"]

TRAVERSE = "octree_traverse_kernel<false>"
LIVE = "octree_live_rays"


def read(ctx):
    prof = ctx.rec.get("profile")
    packed = getattr(ctx.ref_scene, "packed_octree", None)
    if prof is None or packed is None:
        return None
    launches = sum(c for name, (_, c) in prof["ops"].items()
                   if TRAVERSE in name)
    if launches == 0:
        return None
    kernel_s = sum(s for name, (s, _) in prof["ops"].items()
                   if TRAVERSE in name or LIVE in name) / launches
    seed, focal = prof["params"]
    camera, cfg = scenes.view(ctx.ref, ctx.config, ctx.cell, focal, seed)
    integ = ctx.ref.integ
    with torch.no_grad():
        _, _, _, o, d = integ.camera_wavefront(
            camera, cfg, integ.make_filter(cfg), 0, ctx.ref_scene.device)
        t_max = torch.full_like(o[..., 0], math.inf)
        out = ctx.ref.octree.octree_traverse(
            o, d, t_max, packed.tree, packed.tri_verts, packed.tri_mask,
            pops=True)
    n = o.shape[0]
    bound_s, which = roofline.octree_closest_bound(
        n, n, int(out[4].sum()), int(out[5].sum()), packed.nbytes())
    print(f"octree_roofline: bound {bound_s * 1e3:.6f} ms ({which}), "
          f"kernel {kernel_s * 1e3:.6f} ms a launch", file=ctx.log)
    return 100.0 * bound_s / kernel_s
