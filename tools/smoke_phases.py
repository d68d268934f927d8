"""Some of ``chip_smoke.py``'s later phases alone, after the Cornell
headline render of its phase 4 that phase 16 is held to.

    python tools/smoke_phases.py [PHASE ...]

PHASE is any of 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27 (default:
16 17). Builds the kernels, then runs the phases asked for, each printing its
lines as in the smoke; for 16 and 22 it first renders the Cornell
headline (512x512, spp 32, path/MIS depth 4) through ``render()`` after
one warm-up pass: ``chip_smoke.sharded_phase`` (16:
``render_distributed`` at world size 1 over NCCL, captured and eager in
turns, two spawned ranks on the card over gloo, config 5's sharded train
step, captured and eager in turns at world size 1),
``chip_smoke.options_card_phase`` (17: the sobol_global headline and the
128x128 option and camera passes against the CPU),
``chip_smoke.raytracer_phase`` (18: the raytracer app, its resume),
``chip_smoke.shape_phase`` (19: the shape_test app on the card and the
CPU), ``chip_smoke.scene_file_phase`` (20: the OBJ/PLY loaders and a JSON
scene file, loaded cold and warm through the octree cache),
``chip_smoke.apps_phase`` (21: the eight validation apps on the card and
the CPU) and ``chip_smoke.api_phase`` (22: the reference's call forms,
alive fractions and effective rays/s from this run's s/pass) and
``chip_smoke.graph_phase`` (23: the captured pass against the eager loop
on five scenes, building the mesh and canonical scenes) and
``chip_smoke.train_graph_phase`` (24: config 5's captured train step
against its eager loop, in turns) and ``chip_smoke.sampler_phase`` (25:
the sampler kernel against its plain version at the cells' draws, timed,
and its launches a pass or a step) and ``chip_smoke.kept_sharded_phase``
(26: four ranks on four cards over NCCL, ``render_distributed``'s kept
step graph against the eager steps; needs four cards) and
``chip_smoke.shade_phase`` (27: the shade kernel against the torch route
on three scenes, bitwise, timed, with its launches a pass); then one line
of each phase's seconds. Phase
16's config 5 line carries no 14b time (14b does not run here). Needs a
CUDA card; imports nothing of JAX.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from computational_ray_tracer_tpu_torch import entry  # noqa: E402
from computational_ray_tracer_tpu_torch.kernels import build  # noqa: E402
from computational_ray_tracer_tpu_torch.models import (  # noqa: E402
    integrator as integ)
from computational_ray_tracer_tpu_torch.ops import film as filmmod  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("smoke_phases.py: no CUDA device")
    t_start = time.perf_counter()
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    dev = torch.device("cuda", 0)
    seconds = {}

    def headline():
        """(film on the host, s/pass) of phase 4's headline, rendered once,
        for the phases held to it."""
        if "render_s_per_pass" not in seconds:
            scene, camera, cfg = entry.cornell_setup(cs.HEADLINE_RES,
                                                     cs.HEADLINE_SPP, dev)
            integ.render(scene, camera, cfg, passes=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            film, _ = integ.render(scene, camera, cfg, chunk=cs.HEADLINE_SPP)
            torch.cuda.synchronize()
            seconds["render_s_per_pass"] = ((time.perf_counter() - t0)
                                            / cs.HEADLINE_SPP)
            seconds["ref"] = filmmod.Film(film.rgb_sum.cpu(),
                                          film.weight_sum.cpu(),
                                          film.spp_done)
        return seconds["ref"], seconds["render_s_per_pass"]

    phases = {
        "16": lambda: cs.sharded_phase(dev, card, *headline(), None),
        "17": lambda: cs.options_card_phase(dev, card),
        "18": lambda: cs.raytracer_phase(dev, card),
        "19": lambda: cs.shape_phase(dev, card),
        "20": lambda: cs.scene_file_phase(dev, card),
        "21": lambda: cs.apps_phase(dev, card),
        "22": lambda: cs.api_phase(dev, card, headline()[1]),
        "23": lambda: cs.graph_phase(dev, card),
        "24": lambda: cs.train_graph_phase(dev, card),
        "25": lambda: cs.sampler_phase(dev, card),
        "26": lambda: cs.kept_sharded_phase(card),
        "27": lambda: cs.shade_phase(dev, card),
    }
    for name in sys.argv[1:] or ["16", "17"]:
        t0 = time.perf_counter()
        phases[name]()
        seconds["phase" + name] = time.perf_counter() - t0
    seconds.pop("ref", None)
    seconds["total"] = time.perf_counter() - t_start
    print("seconds", seconds, flush=True)


if __name__ == "__main__":
    main()
