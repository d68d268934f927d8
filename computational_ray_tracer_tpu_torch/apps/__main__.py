"""CLI dispatcher: ``python -m computational_ray_tracer_tpu_torch.apps
<name> [--out DIR] [--device DEVICE]`` runs the app's ``main`` on DEVICE
(``cuda`` by default)."""

from __future__ import annotations

import argparse
import importlib
import sys

from computational_ray_tracer_tpu_torch.apps import APP_NAMES


def main(argv=None):
    p = argparse.ArgumentParser(prog="computational_ray_tracer_tpu_torch.apps",
                                description=__doc__)
    p.add_argument("app", choices=APP_NAMES)
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda or cpu)")
    args, _ = p.parse_known_args(argv)
    mod = importlib.import_module(
        f"computational_ray_tracer_tpu_torch.apps.{args.app}")
    return mod.main(outdir=args.out, device=args.device)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
