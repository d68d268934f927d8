"""The readings that the check's limits are set from, for one cell, in one
process on the card (never part of a benchmark run):

    python3 gpubench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--seconds S] [--steps N] [--out FILE]

Set-up once; then for each seed a short window at the cell's own sizes and
load (``--seconds``; an inverse job of ``--steps`` steps, whose first
three are the ones compared) and three readings of the check's numbers:
``program`` (the port against the plain reference: the lower readings),
``control`` (the reference computed with its intermediates stored in
bfloat16, put in the program's place: the upper readings) and, for an
inverse job, ``half_batch`` (the reference with its loss taken over half
the image, a fault a training cell can have). Prints one JSON line a seed
and appends it to ``--out``."""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@contextlib.contextmanager
def half_batch(ref):
    """The reference's loss taken over the top half of the image only."""
    inverse = ref.inverse
    base = inverse.make_loss_fn

    def make_loss_fn(camera, cfg, extract_insert, target):
        _, insert = extract_insert
        render_image, _ = inverse.make_render_fn(camera, cfg)
        half = target.shape[0] // 2

        def loss(params, scene):
            img = render_image(insert(scene, params))
            return ((img[:half] - target[:half]) ** 2).mean()
        return loss

    inverse.make_loss_fn = make_loss_fn
    try:
        yield
    finally:
        inverse.make_loss_fn = base


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.001)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    from gpubench import cells, harness, scenes
    from gpubench.reference import precision

    cell = cells.cell(args.workload)
    if cell["kind"] == "inverse_job":
        cell["steps"] = args.steps
    config = cells.config(cell["config"])
    kind = cells.kind(cell["kind"])
    t0 = time.perf_counter()
    st = kind.setup(cell, config, args.device)
    print(f"setup {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    ref = scenes.namespace(scenes.REFERENCE)
    ref_scene = scenes.build_scene(ref, config, st.arrays, args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = kind.window(st, seed, args.seconds, False)
        row = {"workload": args.workload, "seed": seed,
               "items": rec["attempted"],
               "program": kind.check(st, rec, seed, ref, ref_scene),
               "control": kind.check(st, rec, seed, ref, ref_scene,
                                     lowered=precision.lowered)}
        if cell["kind"] == "inverse_job":
            row["half_batch"] = kind.check(
                st, rec, seed, ref, ref_scene,
                fault=lambda: half_batch(ref))
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        del rec
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if harness.forbidden_modules():
        print(f"loaded: {harness.forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
