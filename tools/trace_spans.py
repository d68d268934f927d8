"""A traced run of a benchmark cell with the per-layer metrics that read the
port's own spans and counters, and the recorder's cost with no profiler.

    python3 tools/trace_spans.py --workload <cell> --seed <n> --seconds <s>
                                 [--out DIR]
    python3 tools/trace_spans.py --cost [--reps 7]

The first form runs the cell as ``gpubench/run.py --trace 1`` does, with
the cell's per-layer metrics and, beside them, every reader of
``gpubench/metrics/`` built on ``gpubench/span_readers.py`` that lists the
cell. Prints the result line, then a line ``spans:`` with what the
readers' numbers are checked against: the profiled frame's ``crt.pass``
device ms (its last replayed pass), the sampler and intersection device
ms beside it, what ``first_pass_ms.frames`` holds (eager pass plus
capture, or on a window whose every frame replayed a kept graph one
replay, ``replay_ms``), the window's frames that replayed a kept graph
and that captured one (the ``crt.graph.kept`` / ``crt.graph.captured``
counters) and the share that replayed, the share of the profiled
frame's bounces that shaded in the shade kernel (the ``crt.shade.fused``
/ ``crt.shade.torch`` counters of its eager pass and capture; a profiled
job only replays, so it counts none) and the ``crt.shade`` device ms of
its last replay, and the profiled frame's or job's host ms against the
window's median. A frame rendered while the
profiler records takes no kept graph: it runs its own eager pass and
capture, which give its fine spans and counters, so the profiled frame is
one that captures whatever the window's frames did.
Writes every span the recorder holds to ``DIR/<cell>.<seed>.spans.jsonl``
(host seconds, as ``metrics.spans()`` gives them; by default under the
package's git-ignored build directory).

``--cost`` times the recorder on the card with no profiler recording: a
frame's coarse spans (``crt.frame``, ``crt.pass.eager``,
``crt.pass.capture`` with its two reads of the allocator's counts,
``crt.pass.release``; and again without the two reads), a replayed
step's (``crt.step.host`` around ``crt.step.launch``), and one fine span
(a flag check): each the median over ``--reps`` runs of 1,000, in us.

Needs a CUDA card; imports nothing of JAX."""

import argparse
import json
import os
import statistics
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from computational_ray_tracer_tpu_torch.models import graphs  # noqa: E402
from computational_ray_tracer_tpu_torch.utils import metrics  # noqa: E402

SPAN_METRICS = ("eager_pass_ms.frames", "capture_ms.frames",
                "capture_allocs.frames", "release_ms.frames",
                "sampler_ms.frames", "intersect_ms.frames",
                "alive_share.frames", "step_host_ms.train",
                "step_launch_ms.train")


def span_metrics(cell):
    from gpubench import cells
    return [name for name in SPAN_METRICS
            if cell in cells.metric(name).WORKLOADS]


def run_cell(workload, seed, seconds, out_dir):
    from gpubench import cells, harness, span_readers
    from gpubench import run as bench_run
    print(f"card: {bench_run.card_power_limit()}", file=sys.stderr)
    cell = cells.cell(workload)
    kind = cells.kind(cell["kind"])
    seen = {}
    window = kind.window

    def kept_window(*args):
        seen["rec"] = window(*args)
        return seen["rec"]

    kind.window = kept_window
    over = {"per_layer": cell["per_layer"] + span_metrics(workload)}
    out = harness.run(workload, seed, seconds, True, "cuda", override=over)
    print(json.dumps(out))
    ctx = types.SimpleNamespace(rec=seen["rec"])
    spans = metrics.spans()
    root = "crt.job" if cell["kind"] == "inverse_job" else "crt.frame"
    t_end = seen["rec"]["t_end"]
    in_window = [s for s in spans if s["name"] == root
                 and s["end"] is not None
                 and seen["rec"]["t_start"] <= s["start"] <= t_end]
    window_ms = [(s["end"] - s["start"]) * 1e3 for s in in_window]
    after = [s for s in spans if s["name"] == root and s["start"] > t_end]
    shade = {name: sum(metrics.counters(s["request"]).get(
        f"crt.shade.{name}", 0) for s in after) for name in ("fused", "torch")}
    bounces = shade["fused"] + shade["torch"]
    line = {"cell": workload, "seed": seed,
            "window_root_ms_median": (statistics.median(window_ms)
                                      if window_ms else None),
            "profiled_root_ms": ((after[-1]["end"] - after[-1]["start"]) * 1e3
                                 if after else None),
            "shade_fused": shade["fused"], "shade_torch": shade["torch"],
            "fused_share": shade["fused"] / bounces if bounces else None}
    if root == "crt.frame":
        got = out["metrics"]
        value = lambda name: got.get(name, {}).get("value")
        graphs = {name: sum(metrics.counters(s["request"]).get(
            f"crt.graph.{name}", 0) for s in in_window)
            for name in ("kept", "captured")}
        routes = graphs["kept"] + graphs["captured"]
        first = ("eager pass + capture", None)
        if in_window and graphs["kept"] == len(in_window):
            first = ("one replay", value("replay_ms"))
        elif value("capture_ms.frames") is not None:
            first = (first[0], value("eager_pass_ms.frames")
                     + value("capture_ms.frames"))
        line.update(
            pass_device_ms=span_readers.device_ms(ctx, "crt.pass"),
            shade_ms=span_readers.device_ms(ctx, "crt.shade"),
            sampler_ms=value("sampler_ms.frames"),
            intersect_ms=value("intersect_ms.frames"),
            replay_ms=value("replay_ms"),
            window_frames=len(in_window),
            graph_kept=graphs["kept"], graph_captured=graphs["captured"],
            hit_share=graphs["kept"] / routes if routes else None,
            first_pass_is=first[0], first_pass_expected_ms=first[1],
            first_pass_ms=value("first_pass_ms.frames"))
    print("spans: " + json.dumps(line))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{workload}.{seed}.spans.jsonl"),
              "w") as fh:
        for s in spans:
            fh.write(json.dumps(s) + "\n")


def _us(fn, reps, n=1000):
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t) / n * 1e6)
    return statistics.median(times)


def cost(reps):
    rec = metrics.Recorder()
    dev = torch.device("cuda", torch.cuda.current_device())

    def frame(reads=True):
        with rec.span("crt.frame", root=True):
            with rec.span("crt.pass.eager"):
                pass
            with rec.span("crt.pass.capture") as span:
                if reads:
                    before = graphs.device_allocs(dev)
                    after = graphs.device_allocs(dev)
                    span.attrs.update(device_allocs=after[0] - before[0],
                                      device_frees=after[1] - before[1])
            with rec.span("crt.pass.release"):
                pass

    def step():
        host = rec.span("crt.step.host").open()
        with rec.span("crt.step.launch"):
            pass
        host.close()

    def fine():
        with rec.fine_span("crt.sample"):
            pass

    torch.zeros(1, device=dev)
    print(json.dumps({
        "frame_us": _us(frame, reps),
        "frame_spans_us": _us(lambda: frame(False), reps),
        "step_us": _us(step, reps),
        "fine_span_off_us": _us(fine, reps),
        "allocator_read_us": _us(lambda: graphs.device_allocs(dev), reps),
        "profiler_recording": metrics.recording()}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out",
                   default="computational_ray_tracer_tpu_torch/build/spans")
    p.add_argument("--cost", action="store_true")
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.cost:
        cost(args.reps)
    else:
        run_cell(args.workload, args.seed, args.seconds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
