"""One run of one cell: set-up, the measured window, the end-to-end or
per-layer metrics, and the check of the window's outputs against the
plain reference. ``run.py`` is its command line; the tests drive it on
the CPU at small sizes through :func:`run`."""

from __future__ import annotations

import copy
import gc
import sys
import time
import types

import torch

from gpubench import cells, compare, profiling, scenes

# Top-level module names that no run may hold once its window has closed:
# JAX, and the JAX package the port was made from (compared whole: the
# port's own name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "computational_ray_tracer_tpu")


class ForbiddenImport(RuntimeError):
    pass


def merge(base, over):
    """``base`` with the nested dict ``over`` laid over it."""
    out = copy.deepcopy(base)
    for key, val in over.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], val)
        else:
            out[key] = val
    return out


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    loaded = {name.split(".")[0] for name in sys.modules}
    return sorted(loaded.intersection(FORBIDDEN))


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run(workload, seed, seconds, trace, device="cuda", t0=None,
        override=None, config_override=None, log=sys.stderr):
    """The result line's object of one run (``checks`` last).
    ``override`` and ``config_override`` lay values over the cell's and
    the configuration's files (the tests' small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = cells.cell(workload)
    if override:
        cell = merge(cell, override)
    config = cells.config(cell["config"])
    if config_override:
        config = merge(config, config_override)
    kind = cells.kind(cell["kind"])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = kind.setup(cell, config, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    rec = kind.window(st, seed, seconds, trace)
    items = rec["item_s"]
    print(f"window: {len(items)} items in {rec['t_end'] - rec['t_start']:.4f}"
          f" s (host CPU {rec['cpu_s']:.4f} s); item s "
          f"{' '.join(f'{t:.4f}' for t in items)}", file=log)
    rec["profile"] = kind.profile(st, seed, rec) if trace else None
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    metrics = {}
    if not trace:
        values = dict(kind.end_to_end(rec), setup_s=setup_s)
        metrics = {name: {"value": values[name], "unit": unit}
                   for name, unit in cell["end_to_end"].items()}
    kind.release(st, rec)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ref = scenes.namespace(scenes.REFERENCE)
    t_check = time.perf_counter()
    ref_scene = scenes.build_scene(ref, config, st.arrays, device)
    print(f"reference scene: {time.perf_counter() - t_check:.3f} s "
          "(its octree is built at a checkout's first run)", file=log)
    t_check = time.perf_counter()
    values = kind.check(st, rec, seed, ref, ref_scene)
    print(f"check: {time.perf_counter() - t_check:.3f} s", file=log)
    correct, checks = compare.judge(values, cell["limits"])

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if trace:
        ctx = types.SimpleNamespace(cell=cell, config=config, rec=rec,
                                    ref=ref, ref_scene=ref_scene, log=log)
        for name in cell["per_layer"]:
            reader = cells.metric(name)
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        prof = rec["profile"]
        if prof is not None:
            dev["busy_s"] = prof["busy_s"]
            dev["window_s"] = prof["window_s"]
            out["breakdown"] = profiling.breakdown(prof)
    out["checks"] = checks
    # Last, so that what the check and the readers load is caught too.
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded during the run: {', '.join(found)}")
    return out
