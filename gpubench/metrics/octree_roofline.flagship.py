"""octree_roofline.flagship: the least time of the octree launches of one
textured mesh pass (closest hit and any hit at every depth) over the
kernel's profiled device time per pass, in %.

The least time is the sum over the pass's launches of
``roofline.octree_closest_bound`` (4 words written a ray for a closest
hit, 1 for an any hit): the larger of the operations of every triangle
test and slab test at 67 TFLOP/s and the bytes at 3.35 TB/s. Its rays
are those of the first pass of the profiled frame's sampler seed over
every pixel, traced by the benchmark's plain reference
(``reference/textured.py``, on the frozen copy's own tree), whose
traversals count the tests and node pops of the live rays (t_max > 0,
the ones the kernel queues), never the kernel's counters. The kernel's
time is that of ``octree_live_rays`` and ``octree_traverse_kernel`` (both
modes) over the profiled frame, divided by its passes."""

from gpubench import roofline, scenes

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "samples_per_s"
WORKLOADS = ["mesh.flagship"]

KERNELS = ("octree_traverse_kernel", "octree_live_rays")
OUT_WORDS = {"closest": 4, "anyhit": 1}


def read(ctx):
    prof = ctx.rec.get("profile")
    packed = getattr(ctx.ref_scene, "packed_octree", None)
    if prof is None or packed is None:
        return None
    kernel_s = sum(s for name, (s, _) in prof["ops"].items()
                   if any(k in name for k in KERNELS)) / ctx.rec["passes"]
    if kernel_s <= 0.0:
        return None
    from gpubench.reference import textured
    from gpubench.traffic import textured_frames
    seed, focal = prof["params"]
    camera, cfg = scenes.view(ctx.ref, ctx.config, ctx.cell, focal, seed)
    ts = textured_frames.reference_scene(ctx.ref_scene, ctx.config)
    bound_s = 0.0
    for launch in textured.pass_launches(ts, camera, cfg, 0):
        s, which = roofline.octree_closest_bound(
            launch["rays"], launch["live"], launch["tests"], launch["pops"],
            packed.nbytes(), OUT_WORDS[launch["mode"]])
        bound_s += s
        print(f"octree_roofline.flagship: {launch} bound "
              f"{s * 1e3:.6f} ms ({which})", file=ctx.log)
    print(f"octree_roofline.flagship: bound {bound_s * 1e3:.6f} ms, kernel "
          f"{kernel_s * 1e3:.6f} ms a pass", file=ctx.log)
    return 100.0 * bound_s / kernel_s
