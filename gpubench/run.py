"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Runs the cell ``gpubench/workloads/<cell>.json`` on the card: set-up
(loading, building the scene and a short warm-up at the cell's shapes),
then ``--seconds`` of work, then the check of what the window produced
against the plain reference. Prints the numbers compared, each with its
limit, as its last lines on standard error, and one JSON object as its
last line on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last. Exits non-zero, printing no result, without enough CUDA
cards, or if JAX or the JAX package was loaded."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_power_limit():
    """The card's name and power limit as nvidia-smi reads them, or ""."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def main(argv=None):
    args = parse(argv)
    import torch
    from gpubench import cells, harness

    torch.set_num_threads(2)
    cell = cells.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); {found} "
              "found", file=sys.stderr)
        return 2
    print(f"card: {card_power_limit()}", file=sys.stderr)
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T0)
    except harness.ForbiddenImport as err:
        print(err, file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
