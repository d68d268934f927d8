"""GPU smoke run of the PyTorch port (computational_ray_tracer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; imports nothing of JAX. Phases, each printed on its own line; any
failed check raises, so the script exits non-zero:

0. refuse to run without a card; print the card's name and power limit;
1. build (or load) the kernel library from csrc/ with nvcc, one process per
   source, all started together;
2. the brute-force mesh kernel (closest hit) vs its plain PyTorch version
   on the card, on (a) the 512x512 Cornell camera wavefront and (b) a
   seeded 4,096-triangle soup x 262,144 rays with a finite t_max and a 50%
   triangle mask: bitwise agreement, outputs and the three per-ray
   counters; the kernel alone (no wrapper-side fill) timed as replays of a
   CUDA graph of 20 launches, its bound from its own counters;
3. the 128x128 golden Cornell render through the port's render(), against
   tests/golden/config2_cornell_path_128.npy at atol 2e-3*max;
4. the Cornell headline: Cornell box + sphere, 512x512, spp 32, path/MIS
   depth 4, through render(); image checks, seconds per pass and rays/s,
   with the launch counts of both brute-force modes in that run; then (4b)
   the inputs of the 8 brute-force launches of one full-wavefront pass
   (closest and any hit, depths 0-3), each held to the plain version
   bitwise (closest hit: all four outputs; any hit: every bit; the three
   counters), timed as in phase 2 and bounded by its own counters;
5. the octree kernel on the mesh bench scene (entry.mesh327k_setup:
   327,680 triangles, leaf cap 192): set-up times, tree shape and memory;
   (a) closest hit vs the plain traversal on the 512x512 camera wavefront,
   (b) vs the brute-force kernel on the same rays, (c) any hit vs the plain
   traversal on the packet-ordered shadow wavefront of one direct pass,
   (d) closest hit vs the brute-force kernel on the 872,320-triangle
   dragon stand-in (leaf cap 160);
6. golden configuration 3 (textured uv sphere in an octree, direct) at
   128x128 through render(), against tests/golden/
   config3_mesh_octree_textured_128.npy at atol 2e-3*max, with both kernel
   modes launched;
7. the mesh headline: entry.mesh327k_setup(512, spp 4) through render();
   image checks, seconds per pass and rays/s (2 rays per sample), with the
   launch counts of each kernel mode in that run;
8. the flagship (entry.flagship_setup on phase 5's scene: textured,
   thin lens, stratified 2x2, path/MIS depth 4): one 512x512 pass through
   render_pass_compact (alive rays only from depth 1) against the
   full-wavefront render_pass that render() runs, at rtol 1e-4 / atol
   1e-5, with the alive counts per depth, capturing the interpolation
   kernel's inputs of that pass;
9. the interpolation kernel vs its plain version on the card, bitwise, on
   (a) the flagship pass's spectral-cache call (C = 5), (b) its sensor
   call (C = 3), (c) a seeded 471 x 128 table at 2^21 rows with w exactly
   0 and 1 on some rows; both times, the bound, and the time of
   torch.nn.functional.grid_sample on the same inputs (the yardstick;
   the port never calls it);
10. the flagship render: render() over spp 4 after one warm-up pass;
   seconds per pass, rays/s (1 + (D-1) + D rays per sample), launches of
   the interpolation kernel and both octree modes, image checks (finite,
   mean inside a band from a CPU render); then (10b) the inputs of the 8
   octree launches of one full-wavefront pass (closest and any hit,
   depths 0-3), each launch timed, bounded by its own counters and held
   to the plain traversal (hits_agree for closest hit, equality for any
   hit; a seeded subset where all rays would exceed PLAIN_BUDGET_S), and
   the depth-1 closest-hit wavefront timed in raster and in packet order;
11. deep512 (entry.deep512_setup on phase 5's scene, path/MIS depth 8):
   one warm-up pass, then three passes at spp 4; seconds
   per pass, rays/s at 16 rays per sample, launches; then one compacted
   pass against the full wavefront as in phase 8, with its alive counts;
12. the canonical frame (entry.canonical_scene on phase 5's dragon
   stand-in: x5, cap 40, backface culling): set-up times and tree shape;
   the 64x64 spp 4 render against tests/golden/canonical_64.npy at
   atol 2e-3*max; the 500x500 spp 100 frame, seconds per pass and rays/s
   (1 ray per sample); (12b) the octree kernel on the camera wavefront of
   one pass, as in 10b;
13. a JSON line of the kernels, with a row for each brute-force mode, each
   launch of 4b, each launch of 10b and 12b (CUDA-event medians: of 5 for
   the kernels, of 3 for the plain versions and the brute kernel at full
   mesh size, one run of the plain traversal in 10b and 12b; the brute
   kernel in 2 and 4b, the octree kernel in 10b and 12b, the interpolation
   kernel, its plain version and grid_sample timed as replays of a CUDA
   graph of 20 launches; errors; launches; the bound: the least time the
   card could take for the same work, from the counted fp32 operations at
   67 TFLOP/s and the bytes at 3.35 TB/s), then the JSON result line.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.kernels import build
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models import scene as scene_mod
from computational_ray_tracer_tpu_torch.ops import camera as cam
from computational_ray_tracer_tpu_torch.ops import interp_kernel as ik
from computational_ray_tracer_tpu_torch.ops import mesh_intersect_kernel as mik
from computational_ray_tracer_tpu_torch.ops import octree as octmod
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.ops import sensor as sen
from computational_ray_tracer_tpu_torch.ops import triangle as trimod
from computational_ray_tracer_tpu_torch.utils import mesh_gen

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "computational_ray_tracer_tpu_torch/csrc/"
HEADLINE_RES, HEADLINE_SPP = 512, 32
MESH_SPP = 4
# Image mean band of the mesh headline: a CPU render of the same scene at
# 48x48, spp 2 (the plain traversal) has mean 0.3875; +-20%.
MESH_MEAN_BAND = (0.31, 0.47)
# Image mean band of the flagship: a CPU render of the same scene at 48x48,
# spp 4 (the plain kernels) has mean 0.4874; +-20%.
FLAGSHIP_MEAN_BAND = (0.39, 0.585)
DEEP_SPP = 4                # deep512's timed passes, as bench.py's
CANONICAL_RES, CANONICAL_SPP = 500, 100
PLAIN_BUDGET_S = 60.0       # the plain traversal runs on all rays if
PLAIN_SUBSET = 65536        # a subset of this size predicts it fits
FP32_FLOPS = 67e12          # H100 SXM, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=5, warm=True):
    """Warm once (unless the caller just ran ``fn``), then the median of
    ``reps`` CUDA-event timings."""
    if warm:
        fn()
        torch.cuda.synchronize()
    return statistics.median(timed(fn)[1] for _ in range(reps))


def per_launch_ms(fn, reps=5, inner=20):
    """Median over ``reps`` of the CUDA-event time of one replay of a CUDA
    graph of ``inner`` calls, per call (for kernels of tens of
    microseconds, whose eager launches would measure the host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(timed(graph.replay)[1] / inner
                             for _ in range(reps))


def ptxas_report(log):
    """What nvcc's ``-Xptxas -v`` says of each kernel in ``log``: its
    (mangled) name, then its stack frame and spills, then its registers and
    shared memory."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            out.append(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            out.append(line.replace("ptxas info    : ", "").strip())
    return out


def timed(fn):
    """(fn(), its CUDA-event milliseconds), one run."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def bound(flops, nbytes):
    """The least time (ms) the card could take: the larger of the fp32
    operations over the fp32 peak and the bytes over the memory rate."""
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def brute_bound(t_max, counts, f, mask, out_bytes):
    """Bound of a brute-force launch from its own per-ray counters
    ``counts`` = (tests, passed, ranged): mik.EDGE_FLOPS per pair tested
    that fails the edge-sign test, RANGE_FLOPS per pair past it that fails
    the range test, PAIR_FLOPS per pair past both (live rays only; any hit
    up to its first hit); o and d read for the live rays (t_max > 0), t_max
    and ``out_bytes`` of outputs for every ray, the triangles (36 bytes
    each) and the mask once."""
    n, live = t_max.numel(), int((t_max > 0).sum())
    tests, passed, ranged = (int(c.sum()) for c in counts)
    flops = ((tests - passed) * mik.EDGE_FLOPS
             + (passed - ranged) * mik.RANGE_FLOPS + ranged * mik.PAIR_FLOPS)
    return bound(flops, 24 * live + (4 + out_bytes) * n + 36 * f
                 + (0 if mask is None else f))


@contextlib.contextmanager
def wrapped(module, name, before=None, after=None):
    """Replace module.name for the block: ``before(*args)`` sees every
    call's arguments and ``after(seconds)`` its host time to a sync."""
    fn = getattr(module, name)

    def call(*args, **kw):
        if before is not None:
            before(*args)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        if after is not None:
            after(time.perf_counter() - t0)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def compare(name, o, d, t_max, mesh, mask):
    """Phase 2: the closest-hit wrapper the scene calls launches the kernel
    on card tensors, then mesh_launch_row holds it to the plain version,
    times it and bounds it."""
    launches0 = mik.LAUNCHES
    mik.mesh_intersect(o, d, t_max, mesh, mask)
    torch.cuda.synchronize()
    assert mik.LAUNCHES == launches0 + 1, f"{name}: the kernel did not launch"
    row = mesh_launch_row(name, "closest", (o, d, t_max), mesh, mask)
    row["triangles"] = mesh.n_triangles
    print("phase2", json.dumps(row), flush=True)
    return row


def soup(n_tris, n_rays, seed, device):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e1, base + e2])
    idx = np.stack([np.arange(n_tris) + k * n_tris for k in range(3)], 1)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(a, device=device)
    return trimod.MeshData.build(pos, idx, device=device), t(o), t(d)


def image_checks(img):
    h, w, _ = img.shape
    rows = slice(int(0.35 * h), int(0.65 * h))
    left = img[rows, int(0.02 * w):int(0.12 * w)].reshape(-1, 3).mean(0)
    right = img[rows, int(0.88 * w):int(0.98 * w)].reshape(-1, 3).mean(0)
    mean = float(img.mean())
    assert np.isfinite(img).all(), "non-finite pixels"
    assert 0.05 < mean < 0.9, f"image mean {mean}"
    assert left[0] > left[1] and left[0] > left[2], f"left wall {left}"
    assert right[1] > right[0] and right[1] > right[2], f"right wall {right}"
    return mean, left.tolist(), right.tolist()


def golden_check(phase, setup, golden_name):
    """Render ``setup`` through render() and hold it to a golden."""
    g_scene, g_camera, g_cfg = setup
    film, sensor = integ.render(g_scene, g_camera, g_cfg,
                                chunk=g_cfg.sampler.spp)
    img = film.resolve(sensor, to_srgb=False, clip=False).cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  golden_name + ".npy"))
    atol = 2e-3 * max(float(golden.max()), 1e-3)
    g_err = float(np.abs(img - golden).max())
    assert np.isfinite(img).all() and g_err <= atol, \
        f"{phase}: golden max |diff| {g_err} > atol {atol}"
    return {"golden": golden_name, "max_abs_diff": g_err, "atol": atol}


def hits_agree(name, k, r):
    """Closest hits k vs reference r, (t, idx, b1, b2) each: hit masks equal
    on >= 99.99% of rays; where both hit, t within rtol 1e-5 and, where the
    ids agree, b1/b2 within atol 1e-5 (tests/test_pallas_octree.py:40-48);
    ids equal on >= 99.9% of those rays, and an id mismatch only at a tie
    (the two triangles' t within rtol 1e-5, checked with every t)."""
    hk, hr = torch.isfinite(k[0]), torch.isfinite(r[0])
    both = hk & hr
    agree = (hk == hr).float().mean().item() if hk.numel() else 1.0
    same = both & (k[1] == r[1])
    same_id = (same.sum() / both.sum()).item() if both.any() else 1.0
    t_abs = (k[0][both] - r[0][both]).abs()
    t_err = t_abs / r[0][both].abs().clamp(min=1e-30)
    b_err = max([(a[same] - b[same]).abs().max().item() if same.any()
                 else 0.0 for a, b in zip(k[2:4], r[2:4])])
    row = {"case": name, "rays": k[0].numel(),
           "hit_frac": hr.float().mean().item() if hr.numel() else 0.0,
           "hit_agree": agree, "same_id": same_id,
           "id_mismatches": int((both & ~same).sum()),
           "t_rel_err_max": t_err.max().item() if both.any() else 0.0,
           "t_abs_err_max": t_abs.max().item() if both.any() else 0.0,
           "b_abs_err_max": b_err,
           "bitwise": all(torch.equal(a, b) for a, b in zip(k, r))}
    assert agree >= 0.9999, f"{name}: hit masks agree on {agree}"
    assert row["t_rel_err_max"] <= 1e-5, f"{name}: t {row['t_rel_err_max']}"
    assert b_err <= 1e-5, f"{name}: barycentrics {b_err}"
    assert same_id >= 0.999, f"{name}: same triangle on {same_id}"
    return row


def counters(tests, pops):
    return {"tri_tests_mean": tests.float().mean().item(),
            "tri_tests_max": int(tests.max()),
            "node_pops_mean": pops.float().mean().item(),
            "node_pops_max": int(pops.max())}


def octree_bound(packed, t_max, tests, pops, out_words):
    """Bound of one traversal launch from its own counters: the slab
    tests' fp32 operations and mik.EDGE_FLOPS per triangle test, what every
    test needs (the counters do not separate the few tests past the
    edge-sign test, which need up to PAIR_FLOPS); t_max read and
    ``out_words`` 4-byte
    outputs written for every ray, o and d read for the live rays (t_max >
    0) only, and the three tree tables once, or, where it is less (a sparse
    wavefront), one sibling-group row per counted pop and one triangle slot
    per counted test."""
    n, live = t_max.numel(), int((t_max > 0).sum())
    flops = (int(tests.sum()) * mik.EDGE_FLOPS
             + int(pops.sum()) * 8 * okern.SLAB_FLOPS)
    touched = 4 * (int(pops.sum()) * 8 * okern.NODE_LANES
                   + int(tests.sum()) * okern.TRI_LANES)
    return bound(flops, 4 * n * (1 + out_words) + 4 * 6 * live
                 + min(packed.nbytes(), touched))


def plain_traverse(packed, o, d, t_max):
    return octmod.octree_traverse(o, d, t_max, packed.tree, packed.tri_verts,
                                  packed.tri_mask)


def plain_ray_set(packed, o, d, t_max):
    """The rays the plain traversal is held to: all of them if a seeded
    subset of PLAIN_SUBSET predicts they take at most PLAIN_BUDGET_S, else
    that subset. Returns (label, (o, d, t_max), the subset's ms)."""
    n = o.shape[0]
    gen = torch.Generator().manual_seed(0)
    sub = torch.sort(torch.randperm(n, generator=gen)[:PLAIN_SUBSET]).values
    sub = sub.to(o.device)
    _, sub_ms = timed(lambda: plain_traverse(packed, o[sub], d[sub],
                                             t_max[sub]))
    if n <= PLAIN_SUBSET or sub_ms * 1e-3 * n / PLAIN_SUBSET <= PLAIN_BUDGET_S:
        return "all", (o, d, t_max), sub_ms
    return (f"seeded subset of {PLAIN_SUBSET}", (o[sub], d[sub], t_max[sub]),
            sub_ms)


def brute_launch_bound(o, d, t_max, mesh):
    """The bound (ms) of one closest-hit brute-force launch, from the
    kernel's counters, and its pairs past the sign test and past the range
    test per ray (a yardstick for the octree kernel's tests past the sign
    test on the same rays, which its counters do not separate)."""
    counts = mik.mesh_intersect(o, d, t_max, mesh, stats=True)[5:]
    n = t_max.numel()
    return {"brute_bound_ms": brute_bound(t_max, counts, mesh.n_triangles,
                                          None, 16)[0],
            "brute_passed_per_ray": counts[1].sum().item() / n,
            "brute_ranged_per_ray": counts[2].sum().item() / n}


def octree_phase(dev):
    """Phase 5 on the mesh bench scene; returns (scene, camera, cfg, rows)
    with the kernel rows of the closest-hit and any-hit modes."""
    times = {}
    torch.cuda.reset_peak_memory_stats()
    keep = lambda key: lambda s: times.__setitem__(key, s)
    t0 = time.perf_counter()
    with wrapped(octmod, "build_octree", after=keep("build_octree_s")), \
            wrapped(okern, "pack_from_numpy", after=keep("pack_upload_s")):
        scene, camera, cfg = entry.mesh327k_setup(HEADLINE_RES, MESH_SPP,
                                                  device=dev)
    torch.cuda.synchronize()
    times["setup_s"] = time.perf_counter() - t0
    packed = scene.packed_octree
    print("phase5_setup", json.dumps({
        **times, "octree": scene.octree.info(), "depth": packed.depth,
        "triangles": scene.mesh.n_triangles, "cap": packed.cap,
        "leaf_table_mb": packed.leaf_verts.numel() * 4 / 1e6,
        "node_table_mb": packed.nodes.numel() * 4 / 1e6,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6}),
        flush=True)

    # (a) closest hit vs the plain traversal on the camera wavefront
    _, _, _, o, d = integ.camera_wavefront(camera, cfg, integ.make_filter(cfg),
                                           0, dev)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    t_inf = torch.full((n,), float("inf"), device=dev)
    plain = lambda oo, dd, tt: plain_traverse(packed, oo, dd, tt)
    kern = lambda: okern.octree_intersect(o, d, t_inf, packed)
    k = kern()
    rays, ray_set, sub_ms = plain_ray_set(packed, o, d, t_inf)
    k_set = lambda: okern.octree_intersect(*ray_set, packed)
    ms = median_ms(k_set)
    p = plain(*ray_set)
    plain_ms = median_ms(lambda: plain(*ray_set), 3, warm=False)
    row_a = hits_agree("a_closest_vs_plain", k_set(), p[:4])
    _, _, _, _, tests, pops = okern.octree_intersect(*ray_set, packed,
                                                     stats=True)
    bound_ms, bound_by = octree_bound(packed, ray_set[2], tests, pops, 4)
    row_a.update(plain_rays=rays, ms=ms, plain_ms=plain_ms,
                 plain_subset_ms=sub_ms, bound_ms=bound_ms,
                 bound_by=bound_by, **counters(tests, pops))
    print("phase5a", json.dumps(row_a), flush=True)

    # (b) closest hit vs the brute-force kernel, full wavefront
    brute = lambda: mik.mesh_intersect(o, d, t_inf, scene.mesh)[:4]
    row_b = hits_agree("b_closest_vs_brute_kernel", k, brute())
    row_b.update(ms=median_ms(kern), brute_kernel_ms=median_ms(brute, 3),
                 pairs=n * scene.mesh.n_triangles,
                 **brute_launch_bound(o, d, t_inf, scene.mesh))
    print("phase5b", json.dumps(row_b), flush=True)

    # (c) any hit vs plain on the sorted shadow wavefront of a direct pass
    shadow = []
    with wrapped(okern, "octree_anyhit",
                 before=lambda *a: shadow.append([x.clone() for x in a[:3]])):
        integ.render_pass(scene, camera, cfg, integ.make_filter(cfg),
                          sen.PixelSensor.create(), 0)
    assert len(shadow) == 1, f"{len(shadow)} any-hit calls in a direct pass"
    so, sd, st = shadow[0]
    kern_any = lambda: okern.octree_anyhit(so, sd, st, packed)
    h_k = kern_any()
    h_p = plain(so, sd, st)[1] >= 0
    plain_any_ms = median_ms(lambda: plain(so, sd, st), 3, warm=False)
    assert torch.equal(h_k, h_p), \
        f"c: any hit differs on {int((h_k != h_p).sum())} rays"
    _, tests, pops = okern.octree_anyhit(so, sd, st, packed, stats=True)
    bound_any, bound_any_by = octree_bound(packed, st, tests, pops, 1)
    row_c = {"case": "c_anyhit_vs_plain", "rays": st.numel(),
             "alive_frac": (st > 0).float().mean().item(),
             "occluded_frac": h_k.float().mean().item(), "equal": True,
             "ms": median_ms(kern_any), "plain_ms": plain_any_ms,
             "bound_ms": bound_any, "bound_by": bound_any_by,
             **counters(tests, pops)}
    print("phase5c", json.dumps(row_c), flush=True)

    # (d) the irregular reference-scale mesh vs the brute-force kernel
    t0 = time.perf_counter()
    v, f, uv = mesh_gen.dragon_stand_in()
    gen_s = time.perf_counter() - t0
    dmesh = trimod.MeshData.build(v, f, uvs=uv, device=dev)
    t0 = time.perf_counter()
    dtree = octmod.build_octree(v, f, 160)
    build_s = time.perf_counter() - t0
    dpacked = okern.pack_from_numpy(dtree, dmesh)
    dcam = cam.PerspectiveCamera.create((0, 12, -52), (HEADLINE_RES,) * 2,
                                        fov_y=45.0, look_at=(0, -1, 0))
    _, _, _, do, dd = integ.camera_wavefront(dcam, cfg, integ.make_filter(cfg),
                                             0, dev)
    do, dd = do.contiguous(), dd.contiguous()
    kern_d = lambda: okern.octree_intersect(do, dd, t_inf, dpacked)
    dbrute = lambda: mik.mesh_intersect(do, dd, t_inf, dmesh)[:4]
    row_d = hits_agree("d_dragon_closest_vs_brute_kernel", kern_d(),
                       dbrute())
    _, _, _, _, tests, pops = okern.octree_intersect(do, dd, t_inf, dpacked,
                                                     stats=True)
    bound_d, bound_d_by = octree_bound(dpacked, t_inf, tests, pops, 4)
    row_d.update(triangles=dmesh.n_triangles, octree=dtree.info(),
                 depth=dpacked.depth, generate_s=gen_s, build_octree_s=build_s,
                 leaf_table_mb=dpacked.leaf_verts.numel() * 4 / 1e6,
                 ms=median_ms(kern_d), brute_kernel_ms=median_ms(dbrute, 3),
                 bound_ms=bound_d, bound_by=bound_d_by,
                 **brute_launch_bound(do, dd, t_inf, dmesh),
                 max_memory_allocated_mb=torch.cuda.max_memory_allocated()
                 / 1e6, **counters(tests, pops))
    print("phase5d", json.dumps(row_d), flush=True)
    del dpacked, dmesh
    return scene, camera, cfg, row_a, row_c, (v, f, uv)


def capture_launches(fn, module, modes):
    """Run ``fn()`` and return the inputs of every call it makes of the
    kernel wrappers ``modes`` names (wrapper name -> mode) in ``module``:
    a list of (mode, (o, d, t_max) flattened and cloned, the wrapper's
    other positional arguments...)."""
    calls = []
    keep = lambda mode: lambda o, d, t_max, *rest: calls.append(
        (mode, (o.reshape(-1, 3).clone(), d.reshape(-1, 3).clone(),
                t_max.reshape(-1).clone()), *rest))
    with contextlib.ExitStack() as stack:
        for name, mode in modes.items():
            stack.enter_context(wrapped(module, name, before=keep(mode)))
        fn()
    return calls


def capture_octree_launches(fn):
    """The octree kernel's calls: (mode, rays, packed)."""
    return capture_launches(fn, okern, {"octree_intersect": "closest",
                                        "octree_anyhit": "anyhit"})


def capture_mesh_launches(fn):
    """The brute-force kernel's calls: (mode, rays, mesh, tri_mask)."""
    return capture_launches(fn, mik, {"mesh_intersect": "closest",
                                      "mesh_anyhit": "anyhit"})


def mesh_launch_row(name, mode, rays, mesh, mask):
    """The brute-force kernel on one captured launch, through its wrapper:
    held to the plain version bitwise (closest hit: all four outputs; any
    hit: every bit) and on the three counters, bounded by its own counters,
    and timed alone (mik._launch, without the wrapper's count fill) as
    replays of a CUDA graph of 20 launches."""
    o, d, t = rays
    anyhit = mode == "anyhit"
    wrapper = mik.mesh_anyhit if anyhit else mik.mesh_intersect
    plain_fn = mik.mesh_anyhit_plain if anyhit else mik.mesh_intersect_plain
    plain = lambda: plain_fn(o, d, t, mesh.tri_verts, mask)
    k = wrapper(o, d, t, mesh, mask)
    p = plain_fn(o, d, t, mesh.tri_verts, mask, stats=True)
    torch.cuda.synchronize()
    if anyhit:
        assert torch.equal(k, p[0]), \
            f"{name}: any hit differs on {int((k != p[0]).sum())} rays"
        row = {"case": name, "occluded_frac": k.float().mean().item()}
    else:
        assert all(torch.equal(a, b) for a, b in zip(k[:4], p[:4])), \
            f"{name}: closest hit differs on {int((k[1] != p[1]).sum())} ids"
        row = {"case": name, "hit_frac": torch.isfinite(k[0]).float()
               .mean().item()}
    counts = wrapper(o, d, t, mesh, mask, stats=True)[-3:]
    assert all(torch.equal(a, b) for a, b in zip(counts, p[-3:])), \
        f"{name}: the kernel's counters differ from the plain count"
    bound_ms, bound_by = brute_bound(t, counts, mesh.n_triangles, mask,
                                     1 if anyhit else 16)
    ms = per_launch_ms(lambda: mik._launch(anyhit, o, d, t, mesh.tri_verts,
                                           mask, False))
    live = int((t > 0).sum())
    per_live = lambda c: c.sum().item() / max(live, 1)
    row.update(mode=mode, rays=t.numel(), alive=live,
               bitwise=True, max_abs_err=0.0,
               tests_per_live_ray=per_live(counts[0]),
               passed_per_live_ray=per_live(counts[1]),
               ranged_per_live_ray=per_live(counts[2]),
               ms=ms, plain_ms=median_ms(plain, 3), bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms)
    return row


def cornell_launches(scene, camera, cfg, launches):
    """Phase 4b: the brute-force kernel on each of the 8 launches (closest
    and any hit, depths 0-3) of one full-wavefront Cornell pass.
    ``launches``: the kernel's launches per mode in phase 4's render.
    Returns the kernel-line rows."""
    calls = capture_mesh_launches(lambda: integ.render_pass(
        scene, camera, cfg, integ.make_filter(cfg), sen.PixelSensor.create(),
        0))
    depth = cfg.max_depth
    modes = [m for m, *_ in calls]
    assert modes == ["closest", "anyhit"] * depth, modes
    rows = []
    for j, (mode, rays, mesh, mask) in enumerate(calls):
        row = mesh_launch_row(f"cornell_{mode}_d{j // 2}", mode, rays, mesh,
                              mask)
        assert launches[mode] % depth == 0, launches
        row["launches"] = launches[mode] // depth
        print("phase4b", json.dumps(row), flush=True)
        rows.append(row)
    print("phase4b_sum", json.dumps({
        "ms": sum(r["ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows)}), flush=True)
    return rows


def octree_launch_row(name, packed, mode, rays):
    """The octree kernel on one captured launch, through its wrapper: its
    time, its bound from its own counters, and its agreement with the plain
    traversal on all rays or the seeded subset plain_ray_set picks: any
    hit exactly; closest hit by hits_agree over the live rays (t_max > 0,
    so that the dead ones of a sparse wavefront do not dilute it) and
    exactly on the dead ones."""
    o, d, t = (x.contiguous() for x in rays)
    anyhit = mode == "anyhit"
    wrapper = okern.octree_anyhit if anyhit else okern.octree_intersect
    label, ray_set, sub_ms = plain_ray_set(packed, o, d, t)
    p, plain_ms = timed(lambda: plain_traverse(packed, *ray_set))
    k = wrapper(*ray_set, packed)
    if anyhit:
        assert torch.equal(k, p[1] >= 0), \
            f"{name}: any hit differs on {int((k != (p[1] >= 0)).sum())} rays"
        row = {"case": name, "equal": True,
               "occluded_frac": (p[1] >= 0).float().mean().item()}
        err = 0.0
    else:
        live = ray_set[2] > 0
        row = hits_agree(name, [x[live] for x in k], [x[live] for x in p[:4]])
        assert all(torch.equal(a[~live], b[~live])
                   for a, b in zip(k, p[:4])), \
            f"{name}: a dead ray's output differs"
        row.update(live_rays_checked=row.pop("rays"),
                   bitwise=all(torch.equal(a, b) for a, b in zip(k, p[:4])))
        err = max(row["t_abs_err_max"], row["b_abs_err_max"])
    stats = wrapper(o, d, t, packed, stats=True)
    tests, pops = stats[-2:]
    bound_ms, bound_by = octree_bound(packed, t, tests, pops,
                                      1 if anyhit else 4)
    # A CUDA graph of the wrapper's launches: on the sparse bounce
    # wavefronts the kernels take about 0.1 ms, and eager launches would
    # add the host's time between them.
    ms = per_launch_ms(lambda: wrapper(o, d, t, packed))
    row.update(rays=t.numel(), mode=mode, alive=int((t > 0).sum()),
               plain_rays=label,
               plain_subset_ms=sub_ms, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms, max_abs_err=err,
               **counters(tests, pops))
    return row


def flagship_bounces(f_scene, f_camera, f_cfg, launches):
    """Phase 10b: the octree kernel on each of the 8 launches (closest and
    any hit, depths 0-3) of one full-wavefront flagship pass, then the
    depth-1 closest-hit wavefront in packet order as well as raster order.
    ``launches``: the kernel's launches per mode in phase 10's render.
    Returns the kernel-line rows."""
    calls = capture_octree_launches(lambda: integ.render_pass(
        f_scene, f_camera, f_cfg, integ.make_filter(f_cfg),
        sen.PixelSensor.create(), 0))
    depth = f_cfg.max_depth
    modes = [m for m, *_ in calls]
    assert modes == ["closest", "anyhit"] * depth, modes
    packed = f_scene.packed_octree
    rows = []
    for j, (mode, rays, _) in enumerate(calls):
        row = octree_launch_row(f"flagship_{mode}_d{j // 2}", packed, mode,
                                rays)
        assert launches[mode] % depth == 0, launches
        row["launches"] = launches[mode] // depth
        print("phase10b", json.dumps(row), flush=True)
        rows.append(row)
    # The depth-1 bounce rays in raster order (as the scene traces them)
    # and in the shadow rays' (octant, Morton) packet order.
    o, d, t = (x.contiguous() for x in calls[2][1])
    order = scene_mod._packet_order(o, d, t > 0.0)
    so, sd, st = o[order], d[order], t[order]
    k_raster = okern.octree_intersect(o, d, t, f_scene.packed_octree)
    k_sorted = okern.octree_intersect(so, sd, st, f_scene.packed_octree)
    unsorted = [torch.empty_like(x) for x in k_sorted]
    for u, x in zip(unsorted, k_sorted):
        u[order] = x
    assert all(torch.equal(a, b) for a, b in zip(unsorted, k_raster)), \
        "depth 1: packet order changed a closest hit"

    def sort_and_gather():
        i = scene_mod._packet_order(o, d, t > 0.0)
        return o[i], d[i], t[i]

    sort_ms = median_ms(sort_and_gather)
    print("phase10b_order", json.dumps({
        "case": "flagship_closest_d1", "alive": int((t > 0).sum()),
        "raster_ms": median_ms(lambda: okern.octree_intersect(
            o, d, t, f_scene.packed_octree)),
        "packet_ms": median_ms(lambda: okern.octree_intersect(
            so, sd, st, f_scene.packed_octree)),
        "sort_and_gather_ms": sort_ms, "same_hits": True}), flush=True)
    return rows


def interp_bound(n, k, c):
    """Bound of one interpolation launch: i0 and w (8 bytes a row), the
    (n, c) output and the table once; ik.ELEMENT_FLOPS per output."""
    return bound(n * c * ik.ELEMENT_FLOPS, 8 * n + 4 * n * c + 4 * k * c)


def interp_case(name, tables, i0, w):
    """The interpolation kernel (through its wrapper) vs its plain version
    on the same card tensors: raises unless bitwise equal. Times both and
    grid_sample computing the same lerp: the table as a (1, C, 1, K) image
    sampled at x = i0 + w with align_corners=True."""
    k, c = tables.shape
    n = i0.shape[0]
    launches0 = ik.LAUNCHES
    out = ik.dense_interp(tables, i0, w)
    plain = ik.dense_interp_plain(tables, i0, w)
    torch.cuda.synchronize()
    assert ik.LAUNCHES == launches0 + 1, f"{name}: the kernel did not launch"
    bitwise = torch.equal(out, plain)
    err = (out - plain).abs().max().item()
    assert bitwise, f"{name}: interpolation kernel differs by {err}"
    img = tables.T.contiguous().reshape(1, c, 1, k)
    x = (i0.to(torch.float32) + w) * (2.0 / (k - 1)) - 1.0
    grid = torch.stack([x, torch.zeros_like(x)], -1).reshape(1, 1, n, 2)
    lib = lambda: F.grid_sample(img, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
    lib_err = (lib()[0, :, 0].T - out).abs().max().item()
    bound_ms, bound_by = interp_bound(n, k, c)
    row = {"case": name, "rows": n, "k": k, "c": c, "bitwise": bitwise,
           "max_abs_err": err,
           "w_exact_0_1": int(((w == 0) | (w == 1)).sum()),
           "ms": per_launch_ms(lambda: ik.dense_interp(tables, i0, w)),
           "plain_ms": per_launch_ms(
               lambda: ik.dense_interp_plain(tables, i0, w)),
           "library_ms": per_launch_ms(lib),
           "library_max_abs_diff": lib_err,
           "bound_ms": bound_ms, "bound_by": bound_by}
    row["share_of_bound"] = bound_ms / row["ms"]
    print("phase9", json.dumps(row), flush=True)
    return row


def compact_vs_full(phase, scene, camera, cfg, sample_idx):
    """One render_pass_compact pass against the full-wavefront render_pass
    on the card at rtol 1e-4 / atol 1e-5 (tests/test_compaction.py);
    returns (the interpolation kernel's (tables, i0, w) in the compacted
    pass, the first call of each width; the row to print)."""
    flt = integ.make_filter(cfg)
    sensor = sen.PixelSensor.create()
    calls = {}

    def keep(tables, i0, w):
        if tables.shape[1] not in calls:
            calls[tables.shape[1]] = (tables.clone(), i0.clone(), w.clone())

    counts = []
    with wrapped(ik, "dense_interp", before=keep):
        rgb_c, wt_c = integ.render_pass_compact(scene, camera, cfg, flt,
                                                sensor, sample_idx, counts)
    rgb_f, wt_f = integ.render_pass(scene, camera, cfg, flt, sensor,
                                    sample_idx)
    torch.testing.assert_close(wt_c, wt_f, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(rgb_c, rgb_f, rtol=1e-4, atol=1e-5)
    n = cfg.resolution[0] * cfg.resolution[1]
    assert counts[0] == n and min(counts) < n, \
        f"{phase}: alive counts {counts}"
    return calls, {
        "res": cfg.resolution[0], "depth": cfg.max_depth,
        "alive_counts": counts,
        "compact_vs_full_max_abs_diff": (rgb_c - rgb_f).abs().max().item(),
        "rtol": 1e-4, "atol": 1e-5, "image_max": rgb_f.max().item()}


def timed_render(phase, scene, camera, cfg, rays_per_sample, card, film=None,
                 warm=True):
    """One warm-up pass (unless ``film`` resumes a render), then render()
    with every launch count at 0; returns (film, sensor, row)."""
    if warm:
        integ.render(scene, camera, cfg, passes=1)
    torch.cuda.synchronize()
    ik.LAUNCHES = okern.LAUNCHES_CLOSEST = okern.LAUNCHES_ANYHIT = 0
    start = 0 if film is None else film.spp_done
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, film=film)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    passes = film.spp_done - start
    launches = {"interp": ik.LAUNCHES, "closest": okern.LAUNCHES_CLOSEST,
                "anyhit": okern.LAUNCHES_ANYHIT}
    assert min(launches.values()) > 0, f"{phase} launched {launches}"
    w, h = cfg.resolution
    row = {"res": w, "depth": cfg.max_depth, "passes": passes,
           "s_per_pass": dt / passes,
           "rays_per_s": w * h * rays_per_sample * passes / dt,
           "launches": launches, "card": card}
    return film, sensor, row


def canonical_phase(dragon, dev, card):
    """Phase 12; returns the kernel-line row of the octree kernel on the
    500x500 camera wavefront (12b)."""
    times = {}
    keep = lambda key: lambda s: times.__setitem__(key, s)
    t0 = time.perf_counter()
    with wrapped(octmod, "build_octree", after=keep("build_octree_s")), \
            wrapped(okern, "pack_from_numpy", after=keep("pack_upload_s")):
        c_scene = entry.canonical_scene(40, mesh=dragon, device=dev)
    torch.cuda.synchronize()
    times["setup_s"] = time.perf_counter() - t0
    packed = c_scene.packed_octree
    print("phase12_setup", json.dumps({
        **times, "octree": c_scene.octree.info(), "depth": packed.depth,
        "triangles": c_scene.mesh.n_triangles,
        "kept_by_backface_cull": int(c_scene.tri_mask.sum()),
        "leaf_table_mb": packed.leaf_verts.numel() * 4 / 1e6}), flush=True)

    ik.LAUNCHES = okern.LAUNCHES_CLOSEST = 0
    img64, _ = entry.canonical_render(64, 4, scene=c_scene)
    img64 = img64.cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "canonical_64.npy"))
    atol = 2e-3 * max(float(golden.max()), 1e-3)
    g_err = float(np.abs(img64 - golden).max())
    assert np.isfinite(img64).all() and g_err <= atol, \
        f"canonical golden max |diff| {g_err} > atol {atol}"
    assert ik.LAUNCHES > 0 and okern.LAUNCHES_CLOSEST > 0
    print("phase12_golden", json.dumps({
        "golden": "canonical_64", "max_abs_diff": g_err, "atol": atol,
        "launches_interp": ik.LAUNCHES,
        "launches_closest": okern.LAUNCHES_CLOSEST}), flush=True)

    camera, cfg = entry.canonical_view(CANONICAL_RES, CANONICAL_SPP)
    entry.canonical_pass(c_scene, camera, cfg, sen.PixelSensor.create(), 0)
    torch.cuda.synchronize()
    ik.LAUNCHES = okern.LAUNCHES_CLOSEST = okern.LAUNCHES_ANYHIT = 0
    t0 = time.perf_counter()
    img, _ = entry.canonical_render(CANONICAL_RES, CANONICAL_SPP,
                                    scene=c_scene)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"interp": ik.LAUNCHES, "closest": okern.LAUNCHES_CLOSEST,
                "anyhit": okern.LAUNCHES_ANYHIT}
    assert launches["interp"] > 0 and launches["closest"] > 0, launches
    img = img.cpu().numpy()
    mean = float(img.mean())
    assert np.isfinite(img).all() and mean > 0.01, f"canonical mean {mean}"
    print("phase12", json.dumps({
        "res": CANONICAL_RES, "spp": CANONICAL_SPP,
        "s_per_pass": dt / CANONICAL_SPP,
        "rays_per_s": CANONICAL_RES ** 2 * CANONICAL_SPP / dt,
        "launches": launches, "image_mean": mean, "card": card}), flush=True)

    # 12b: the octree kernel on the 500x500 camera wavefront of one pass
    calls = capture_octree_launches(lambda: entry.canonical_pass(
        c_scene, camera, cfg, sen.PixelSensor.create(), 0))
    assert [m for m, *_ in calls] == ["closest"], [m for m, *_ in calls]
    row = octree_launch_row("canonical_closest", packed, "closest",
                            calls[0][1])
    row["launches"] = launches["closest"]
    print("phase12b", json.dumps(row), flush=True)
    return row


def main():
    # phase 0
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this is a GPU run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print("phase0", json.dumps({"device": kind, "torch": torch.__version__,
                                "cuda": torch.version.cuda}), flush=True)

    # phase 1
    t0 = time.perf_counter()
    build.load_library()
    print("phase1", json.dumps({
        "load_s": time.perf_counter() - t0, "nvcc_s": build.build_seconds,
        "ptxas": ptxas_report(build.build_log)}), flush=True)

    # phase 2
    scene, camera, cfg = entry.cornell_setup(HEADLINE_RES, HEADLINE_SPP, dev)
    _, _, _, o, d = integ.camera_wavefront(
        camera, cfg, integ.make_filter(cfg), 0, dev)
    t_inf = torch.full((o.shape[0],), float("inf"), device=dev)
    rows = [compare("cornell_camera", o.contiguous(), d.contiguous(), t_inf,
                    scene.mesh, None)]
    mesh_s, o_s, d_s = soup(4096, 262144, 0, dev)
    mask = torch.as_tensor(np.arange(4096) % 2 == 0, device=dev)
    rows.append(compare("soup_4096_tmax_mask", o_s, d_s,
                        torch.full((262144,), 1.5, device=dev), mesh_s, mask))

    # phase 3
    launches0 = mik.LAUNCHES
    row = golden_check("phase3", entry.golden2_cornell_path(128, 4, dev),
                       "config2_cornell_path_128")
    assert mik.LAUNCHES > launches0, "golden render did not launch the kernel"
    print("phase3", json.dumps({**row, "launches": mik.LAUNCHES - launches0}),
          flush=True)

    # phase 4: one warm-up pass, then the timed Cornell headline render
    integ.render(scene, camera, cfg, passes=1)
    torch.cuda.synchronize()
    mik.LAUNCHES = mik.LAUNCHES_ANYHIT = ik.LAUNCHES = 0
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, chunk=HEADLINE_SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"closest": mik.LAUNCHES, "anyhit": mik.LAUNCHES_ANYHIT}
    c_interp = ik.LAUNCHES
    assert min(launches.values()) > 0 and c_interp > 0, \
        f"the headline render launched the kernels {launches}, {c_interp}"
    img = film.resolve(sensor).cpu().numpy()
    mean, left, right = image_checks(img)
    depth = cfg.max_depth
    rays = HEADLINE_RES * HEADLINE_RES * HEADLINE_SPP * (1 + (depth - 1)
                                                         + depth)
    print("phase4", json.dumps({
        "res": HEADLINE_RES, "spp": HEADLINE_SPP, "depth": depth,
        "s_per_pass": dt / HEADLINE_SPP, "rays_per_s": rays / dt,
        "launches": launches, "launches_interp": c_interp,
        "image_mean": mean, "left_wall": left,
        "right_wall": right, "card": card}), flush=True)
    cornell_rows = cornell_launches(scene, camera, cfg, launches)
    del scene, film, mesh_s, o_s, d_s

    # phase 5
    m_scene, m_camera, m_cfg, row_closest, row_any, dragon = octree_phase(
        dev)

    # phase 6
    before = (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT)
    row = golden_check("phase6",
                       entry.golden3_mesh_octree_textured(128, 2, dev),
                       "config3_mesh_octree_textured_128")
    modes = (okern.LAUNCHES_CLOSEST - before[0],
             okern.LAUNCHES_ANYHIT - before[1])
    assert min(modes) > 0, f"golden 3 launched the modes {modes} times"
    print("phase6", json.dumps({**row, "launches_closest": modes[0],
                                "launches_anyhit": modes[1]}), flush=True)

    # phase 7: one warm-up pass, then the timed mesh headline render
    integ.render(m_scene, m_camera, m_cfg, passes=1)
    torch.cuda.synchronize()
    okern.LAUNCHES_CLOSEST = okern.LAUNCHES_ANYHIT = ik.LAUNCHES = 0
    t0 = time.perf_counter()
    film, sensor = integ.render(m_scene, m_camera, m_cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m_launches = (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT)
    m_interp = ik.LAUNCHES
    assert min(m_launches) > 0 and m_interp > 0, \
        f"mesh headline launched {m_launches}, interp {m_interp}"
    img = film.resolve(sensor).cpu().numpy()
    h, w, _ = img.shape
    centre = img[int(0.45 * h):int(0.55 * h), int(0.45 * w):int(0.55 * w)]
    m_mean = float(img.mean())
    assert np.isfinite(img).all(), "non-finite pixels"
    covered = float((centre.max(-1) > 0).mean())
    assert covered > 0.99, f"the mesh covers {covered} of the centre"
    assert img[:8, :8].max() == 0.0, "a corner that misses the mesh is lit"
    assert MESH_MEAN_BAND[0] < m_mean < MESH_MEAN_BAND[1], \
        f"mesh image mean {m_mean} outside {MESH_MEAN_BAND}"
    print("phase7", json.dumps({
        "res": HEADLINE_RES, "spp": MESH_SPP,
        "s_per_pass": dt / MESH_SPP,
        "rays_per_s": HEADLINE_RES * HEADLINE_RES * 2 * MESH_SPP / dt,
        "launches_closest": m_launches[0], "launches_anyhit": m_launches[1],
        "launches_interp": m_interp,
        "image_mean": m_mean, "centre_mean": float(centre.mean()),
        "card": card}), flush=True)

    # phase 8: the flagship's compacted pass vs its full wavefront
    f_scene, f_camera, f_cfg = entry.flagship_setup(
        HEADLINE_RES, MESH_SPP, scene=m_scene, device=dev)
    calls, row = compact_vs_full("phase8", f_scene, f_camera, f_cfg, 0)
    assert sorted(calls) == [3, 5], f"interp calls of widths {sorted(calls)}"
    print("phase8", json.dumps(row), flush=True)

    # phase 9: the interpolation kernel at its three shapes
    gen = np.random.default_rng(0)
    n_stress = 1 << 21
    w_stress = gen.uniform(0, 1, n_stress).astype(np.float32)
    w_stress[:1000] = 0.0
    w_stress[1000:2000] = 1.0
    t = lambda a: torch.as_tensor(a, device=dev)
    interp_rows = [
        interp_case("a_flagship_spectral_cache", *calls[5]),
        interp_case("b_flagship_sensor", *calls[3]),
        interp_case("c_seeded_471x128", t(gen.normal(size=(471, 128)).astype(
            np.float32)), t(gen.integers(0, 470, n_stress).astype(np.int32)),
            t(w_stress))]
    del calls

    # phase 10: the flagship render
    film, sensor, row = timed_render("phase10", f_scene, f_camera, f_cfg,
                                     1 + (f_cfg.max_depth - 1)
                                     + f_cfg.max_depth, card)
    f_launches = row["launches"]
    img = film.resolve(sensor).cpu().numpy()
    f_mean = float(img.mean())
    assert np.isfinite(img).all(), "non-finite flagship pixels"
    assert FLAGSHIP_MEAN_BAND[0] < f_mean < FLAGSHIP_MEAN_BAND[1], \
        f"flagship image mean {f_mean} outside {FLAGSHIP_MEAN_BAND}"
    print("phase10", json.dumps({**row, "spp": f_cfg.sampler.spp,
                                 "image_mean": f_mean}), flush=True)
    bounce_rows = flagship_bounces(f_scene, f_camera, f_cfg, f_launches)
    del f_scene, film

    # phase 11: deep512, one warm-up pass at spp 2, then passes 1-3 of 4
    d_scene, d_camera, d_cfg = entry.deep512_setup(scene=m_scene, device=dev)
    film, _ = integ.render(d_scene, d_camera, d_cfg, passes=1)
    d_cfg = dataclasses.replace(d_cfg, sampler=dataclasses.replace(
        d_cfg.sampler, spp=DEEP_SPP))
    film, sensor, row = timed_render("phase11", d_scene, d_camera, d_cfg,
                                     16, card, film=film, warm=False)
    img = film.resolve(sensor).cpu().numpy()
    assert np.isfinite(img).all(), "non-finite deep512 pixels"
    _, c_row = compact_vs_full("phase11", d_scene, d_camera, d_cfg, 0)
    print("phase11", json.dumps({**row, "image_mean": float(img.mean()),
                                 "compacted_pass": c_row}), flush=True)
    del m_scene, d_scene, film

    # phase 12: the canonical frame
    canonical_row = canonical_phase(dragon, dev, card)

    # phase 13
    cam_row = rows[0]
    kernel = lambda name, src, replaces, n, r, err: {
        "name": name, "route": "cuda", "source": PKG + src,
        "replaces": replaces, "launches": n, "max_abs_err": err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
    octree_src = "computational_ray_tracer_tpu/ops/pallas_octree.py:242"
    brute_src = "computational_ray_tracer_tpu/ops/pallas_intersect.py:72"
    print(json.dumps({"kernels": [
        kernel("mesh_intersect", "mesh_intersect.cu", brute_src,
               launches["closest"], cam_row,
               max(r["max_abs_err"] for r in rows + cornell_rows)),
        kernel("mesh_anyhit", "mesh_intersect.cu", brute_src,
               launches["anyhit"], cornell_rows[1], 0.0)] + [
            kernel(f"mesh_{r['case']}", "mesh_intersect.cu", brute_src,
                   r["launches"], r, r["max_abs_err"])
            for r in cornell_rows] + [
        kernel("octree_closest", "octree_traverse.cu", octree_src,
               m_launches[0], row_closest,
               max(row_closest["t_abs_err_max"],
                   row_closest["b_abs_err_max"])),
        kernel("octree_anyhit", "octree_traverse.cu", octree_src,
               m_launches[1], row_any, 0.0),
        {**kernel("dense_interp", "dense_interp.cu",
                  "computational_ray_tracer_tpu/ops/pallas_interp.py:36",
                  f_launches["interp"], interp_rows[0],
                  max(r["max_abs_err"] for r in interp_rows)),
         "library_ms": interp_rows[0]["library_ms"]}] + [
            kernel(f"octree_{r['case']}", "octree_traverse.cu", octree_src,
                   r["launches"], r, r["max_abs_err"])
            for r in bounce_rows + [canonical_row]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
