"""GPU smoke run of the PyTorch port (computational_ray_tracer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; imports nothing of JAX. Phases, each printed on its own line; any
failed check raises, so the script exits non-zero:

0. refuse to run without a card; print the card's name and power limit;
1. build (or load) the kernel library from csrc/ with nvcc;
2. mesh-intersection kernel vs its plain PyTorch version on the card, on
   (a) the 512x512 Cornell camera wavefront and (b) a seeded 4,096-triangle
   soup x 262,144 rays with a finite t_max and a 50% triangle mask: bitwise
   agreement (or the reference's own tolerances), and both times;
3. the 128x128 golden Cornell render through the port's render(), against
   tests/golden/config2_cornell_path_128.npy at atol 2e-3*max;
4. the headline: Cornell box + sphere, 512x512, spp 32, path/MIS depth 4,
   through render(); image checks, seconds per pass and rays/s, with the
   kernel launch counts of that run;
5. a JSON line of the kernels, then the JSON result line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.kernels import build
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.ops import mesh_intersect_kernel as mik
from computational_ray_tracer_tpu_torch.ops import triangle as trimod

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "computational_ray_tracer_tpu_torch/csrc/mesh_intersect.cu"
KERNEL_REPLACES = "computational_ray_tracer_tpu/ops/pallas_intersect.py:72"
HEADLINE_RES, HEADLINE_SPP = 512, 32


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=5):
    """Warm once, then the median of ``reps`` CUDA-event timings."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def compare(name, o, d, t_max, mesh, mask):
    """The wrapper the scene calls (it launches the kernel on card tensors)
    vs the plain version on the same tensors; raises unless bitwise equal
    or within the reference's tolerances (tests/test_pallas_intersect.py)."""
    kern = lambda: mik.mesh_intersect(o, d, t_max, mesh, mask)[:4]
    chunk = max(1, (1 << 25) // mesh.n_triangles)
    plain = lambda: mik.mesh_intersect_plain(o, d, t_max, mesh.tri_verts,
                                             mask, chunk=chunk)[:4]
    launches0 = mik.LAUNCHES
    k = kern()
    p = plain()
    torch.cuda.synchronize()
    assert mik.LAUNCHES == launches0 + 1, f"{name}: the kernel did not launch"
    bitwise = all(torch.equal(a, b) for a, b in zip(k, p))
    hk, hp = torch.isfinite(k[0]), torch.isfinite(p[0])
    both = hk & hp
    agree = (hk == hp).float().mean().item()
    same_id = (k[1][both] == p[1][both]).float().mean().item() \
        if both.any() else 1.0
    err = max([(k[0][both] - p[0][both]).abs().max().item() if both.any()
               else 0.0] + [(a - b).abs().max().item()
                            for a, b in zip(k[2:], p[2:])])
    if not bitwise:
        assert agree > 0.995, f"{name}: hit agreement {agree}"
        assert same_id > 0.99, f"{name}: same triangle on {same_id}"
        torch.testing.assert_close(k[0][both], p[0][both], rtol=2e-4,
                                   atol=2e-5)
    ms = median_ms(kern)
    plain_ms = median_ms(plain)
    row = {"case": name, "rays": o.shape[0], "triangles": mesh.n_triangles,
           "bitwise": bitwise, "hit_agree": agree, "same_id": same_id,
           "hit_frac": hk.float().mean().item(), "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms}
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
        "ptxas": [l.strip() for l in build.build_log.splitlines()
                  if "registers" in l or "spill" in l]}), flush=True)

    # phase 2
    scene, camera, cfg = entry.cornell_setup(HEADLINE_RES, HEADLINE_SPP, dev)
    _, _, _, o, d = integ.camera_wavefront(
        camera, cfg, integ.make_filter(), 0, dev)
    t_inf = torch.full((o.shape[0],), float("inf"), device=dev)
    rows = [compare("cornell_camera", o.contiguous(), d.contiguous(), t_inf,
                    scene.mesh, None)]
    mesh_s, o_s, d_s = soup(4096, 262144, 0, dev)
    mask = torch.as_tensor(np.arange(4096) % 2 == 0, device=dev)
    rows.append(compare("soup_4096_tmax_mask", o_s, d_s,
                        torch.full((262144,), 1.5, device=dev), mesh_s, mask))

    # phase 3
    launches0 = mik.LAUNCHES
    g_scene, g_camera, g_cfg = entry.golden2_cornell_path(128, 4, dev)
    film, sensor = integ.render(g_scene, g_camera, g_cfg, chunk=4)
    img = film.resolve(sensor, to_srgb=False, clip=False).cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "config2_cornell_path_128.npy"))
    atol = 2e-3 * max(float(golden.max()), 1e-3)
    g_err = float(np.abs(img - golden).max())
    assert np.isfinite(img).all() and g_err <= atol, \
        f"golden max |diff| {g_err} > atol {atol}"
    assert mik.LAUNCHES > launches0, "golden render did not launch the kernel"
    print("phase3", json.dumps({"max_abs_diff": g_err, "atol": atol,
                                "launches": mik.LAUNCHES - launches0}),
          flush=True)

    # phase 4: one warm-up pass, then the timed headline render
    integ.render(scene, camera, cfg, passes=1)
    torch.cuda.synchronize()
    mik.LAUNCHES = 0
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, chunk=HEADLINE_SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = mik.LAUNCHES
    assert launches > 0, "the headline render never launched the kernel"
    img = film.resolve(sensor).cpu().numpy()
    mean, left, right = image_checks(img)
    depth = cfg.max_depth
    rays = HEADLINE_RES * HEADLINE_RES * HEADLINE_SPP * (1 + (depth - 1)
                                                         + depth)
    print("phase4", json.dumps({
        "res": HEADLINE_RES, "spp": HEADLINE_SPP, "depth": depth,
        "s_per_pass": dt / HEADLINE_SPP, "rays_per_s": rays / dt,
        "launches": launches, "image_mean": mean, "left_wall": left,
        "right_wall": right, "card": card}), flush=True)

    # phase 5
    cam_row = rows[0]
    print(json.dumps({"kernels": [{
        "name": "mesh_intersect", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": cam_row["ms"], "plain_ms": cam_row["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
