"""Warm pass times of the port's path/MIS workloads with and without
between-bounce compaction, in one process on one card.

    python tools/compare_compaction.py [--reps 7] [--out DIR]

For each of the Cornell headline (``entry.cornell_setup(512, 32)``, depth
4), the flagship (``entry.flagship_setup``, depth 4) and deep512
(``entry.deep512_setup``, depth 8; both on one mesh bench scene), times
``--reps`` passes of each of three paths: ``full``, the full-wavefront
``render_pass`` that ``render()`` runs; ``compact``,
``render_pass_compact`` (one alive-count sync per bounce, alive rays only
from depth 1); ``full_synced``, the full wavefront with the same count
sync before each bounce and no gather (what the syncs alone cost). The
paths run interleaved, in an order that rotates each repetition, after one
warm-up pass of each. Each pass is timed on the host clock from its start
to a ``synchronize``, with the same sample index on every path. Prints one
JSON line per workload and writes them all to ``--out/compaction.json``.
A line holds every time, the medians, each path's median over the full
wavefront's, the alive counts per depth and the largest difference from
the full wavefront's image. Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from computational_ray_tracer_tpu_torch import entry  # noqa: E402
from computational_ray_tracer_tpu_torch.models import (  # noqa: E402
    integrator as integ)
from computational_ray_tracer_tpu_torch.ops import sensor as sen  # noqa: E402


def wall(fn):
    """(fn(), host seconds from its start to a synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compare(name, scene, camera, cfg, reps):
    flt, sensor = integ.make_filter(cfg), sen.PixelSensor.create()
    alive = []
    full = lambda i: integ.render_pass(scene, camera, cfg, flt, sensor, i)
    real_step = integ._bounce_step

    def synced_step(scene, cfg, state, *args):
        int(state["alive"].sum())
        return real_step(scene, cfg, state, *args)

    def full_synced(i):
        integ._bounce_step = synced_step
        try:
            return full(i)
        finally:
            integ._bounce_step = real_step

    paths = {"full": full,
             "compact": lambda i: integ.render_pass_compact(
                 scene, camera, cfg, flt, sensor, i,
                 alive if i == 0 else None),
             "full_synced": full_synced}
    out = {key: wall(lambda: fn(0))[0] for key, fn in paths.items()}
    keys = list(paths)
    times = {key: [] for key in keys}
    for r in range(reps):
        for j in range(len(keys)):
            key = keys[(r + j) % len(keys)]
            times[key].append(wall(lambda: paths[key](1 + r))[1])
    med = {key: statistics.median(v) for key, v in times.items()}
    return {"workload": name, "res": cfg.resolution[0],
            "depth": cfg.max_depth, "reps": reps, "alive_counts": alive,
            "s": times, "median_s": med,
            "over_full": {key: med[key] / med["full"] for key in keys},
            "max_abs_diff_vs_full": {
                key: (out[key][0] - out["full"][0]).abs().max().item()
                for key in keys}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out",
                    default="computational_ray_tracer_tpu_torch/build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_compaction.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rows = []
    with torch.no_grad():
        run = lambda name, setup: rows.append(compare(
            name, *setup, args.reps))
        run("cornell", entry.cornell_setup(512, 32, dev))
        m_scene, _, _ = entry.mesh327k_setup(512, 4, device=dev)
        run("flagship", entry.flagship_setup(512, 4, scene=m_scene,
                                             device=dev))
        run("deep512", entry.deep512_setup(scene=m_scene, device=dev))
    for row in rows:
        row["card"] = card
        print(json.dumps(row), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "compaction.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
