"""Inverse jobs: one client submits inverse-rendering jobs in a closed
loop, the next when the last one's parameters are back.

A job recovers the configuration's albedos from a target image: the
cell's ``view`` (resolution, spp, depth, camera) over the configuration,
the target rendered once in set-up from the configuration's own albedos,
and ``inverse.optimize`` run for ``steps`` steps of Adam at ``lr`` over
every leaf of ``inverse.albedo_and_emission_params``, from start albedos
that job k draws from (--seed, k), uniform in ``start_range`` for each
channel of the first ``n_albedos`` materials. Set-up runs a job of
``warmup_steps`` steps at the cell's shapes.

The check draws one of the window's jobs from the seed and follows its
first three steps with the plain reference, which renders its own target
and starts from its own tables: the losses of the three steps, the norm
of the first gradient as the optimizer got it (its first moment after one
step, by leaf) and the norm of the parameters' change after three steps
(by leaf), besides the target image."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gpubench import compare, profiling, scenes

CHECKED_STEPS = 3
# The traced run profiles this many replayed steps of a job after the
# window, from the step after PROFILE_FROM.
PROFILED_STEPS = 5
PROFILE_FROM = 9


@dataclasses.dataclass
class State:
    cell: dict
    config: dict
    device: str
    port: object
    arrays: tuple
    target: object


def start_albedos(cell, seed, k):
    """Job k's start albedos under --seed: (n_albedos, 3)."""
    lo, hi = cell["start_range"]
    rng = np.random.default_rng([seed, k])
    return rng.uniform(lo, hi, size=(cell["n_albedos"], 3)).tolist()


def target_image(ns, st, camera, cfg, device):
    scene = scenes.build_scene(ns, st.config, st.arrays, device)
    render_image, _ = ns.inverse.make_render_fn(camera, cfg)
    with torch.no_grad():
        return render_image(scene)


def setup(cell, config, device):
    port = scenes.namespace(scenes.PORT)
    st = State(cell, config, device, port, scenes.mesh_arrays(config), None)
    camera, cfg = scenes.view(port, config, cell)
    st.target = target_image(port, st, camera, cfg, device)
    run_job(port, st, start_albedos(cell, 0, 0), cell["warmup_steps"],
            device)
    return st


class _Recorded:
    """Keeps the optimizer objects a side's ``optimize`` makes, so the
    check can read the first step's moments (the optimizer's state)."""

    def __init__(self, inverse):
        self.inverse, self.made = inverse, []
        base = inverse.DeviceAdam
        made = self.made

        class Recorded(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                made.append(self)

        self.base, self.cls = base, Recorded

    def __enter__(self):
        self.inverse.DeviceAdam = self.cls
        return self

    def __exit__(self, *exc):
        self.inverse.DeviceAdam = self.base


def run_job(ns, st, albedos, steps, device, target=None, on_step=None):
    """One job of side ``ns`` through its ``inverse.optimize`` (the port's
    captured route, or the reference's eager loop): {"losses", "start",
    "params" (after CHECKED_STEPS steps), "moment" (after step 1),
    "t_call", "t_steps"}."""
    scene = scenes.build_scene(ns, st.config, st.arrays, device, albedos)
    camera, cfg = scenes.view(ns, st.config, st.cell)
    extract_insert = ns.inverse.albedo_and_emission_params(scene)
    start = {k: v.detach().clone() for k, v in extract_insert[0](
        scene).items()}
    out = {"start": start, "params": None, "moment": None, "t_steps": []}

    with _Recorded(ns.inverse) as rec:
        def callback(i, params, loss):
            out["t_steps"].append(time.perf_counter())
            if i == CHECKED_STEPS - 1:
                out["params"] = params
            if i == 0:
                out["moment"] = {k: m.detach().clone() for k, m in
                                 zip(params, rec.made[-1].mu)}
            if on_step is not None:
                on_step(i)

        tgt = st.target if target is None else target
        out["t_call"] = time.perf_counter()
        _, _, losses = ns.inverse.optimize(
            scene, camera, cfg, extract_insert, tgt, steps=steps,
            lr=st.cell["lr"], callback=callback)
    out["losses"] = losses
    return out


def window(st, seed, seconds, trace):
    """Jobs until ``seconds`` have passed (one at least), the job in flight
    finished."""
    jobs = []
    t_start, cpu_start = time.perf_counter(), time.process_time()
    while not jobs or time.perf_counter() - t_start < seconds:
        job = run_job(st.port, st, start_albedos(st.cell, seed, len(jobs)),
                      st.cell["steps"], st.device)
        job["t_done"] = time.perf_counter()
        jobs.append(job)
    if st.device == "cuda":
        torch.cuda.synchronize()
    return {"jobs": jobs, "t_start": t_start, "t_end": time.perf_counter(),
            "cpu_s": time.process_time() - cpu_start,
            "attempted": len(jobs), "failed": 0,
            "item_s": [j["t_done"] - j["t_call"] for j in jobs]}


def profile(st, seed, rec):
    """The traced run's profiled span, after the window (the profiler
    slows the process for the rest of its life): PROFILED_STEPS replayed
    steps of the window's next job, which stops after them."""
    span = {}

    def on_step(i):
        if i == PROFILE_FROM:
            torch.cuda.synchronize()
            span["prof"] = profiling.start()
            span["t0"] = time.perf_counter()
        elif i == PROFILE_FROM + PROFILED_STEPS:
            torch.cuda.synchronize()
            span["wall"] = time.perf_counter() - span["t0"]
            span["prof"].stop()

    if st.device != "cuda":
        return None
    run_job(st.port, st, start_albedos(st.cell, seed, len(rec["jobs"])),
            PROFILE_FROM + PROFILED_STEPS + 1, st.device, on_step=on_step)
    out = profiling.reduce(span["prof"], span["wall"])
    if out is not None:
        out["steps"] = PROFILED_STEPS
    return out


def end_to_end(rec):
    steps = sum(len(j["losses"]) for j in rec["jobs"])
    return {"step_s": (rec["t_end"] - rec["t_start"]) / steps}


def release(st, rec):
    pass


def check(st, rec, seed, ref, ref_scene, lowered=None, fault=None):
    """{number name: value} for one job drawn from the seed, against the
    plain reference's first CHECKED_STEPS steps of the same job.
    ``lowered`` (the control) puts the reference computed under that
    context in the program's place; so does ``fault``, a context that
    plants a fault in the reference's step."""
    rng = np.random.default_rng([seed, compare.CHECK_STREAM])
    k = int(rng.integers(len(rec["jobs"])))
    camera, cfg = scenes.view(ref, st.config, st.cell)
    albedos = start_albedos(st.cell, seed, k)

    def reference():
        target = target_image(ref, st, camera, cfg, st.device)
        job = run_job(ref, st, albedos, CHECKED_STEPS, st.device, target)
        return target, job

    want_target, want = reference()
    if lowered is not None or fault is not None:
        with (lowered or fault)():
            got_target, got = reference()
    else:
        got_target, got = st.target, rec["jobs"][k]
    change = lambda job: {key: job["params"][key] - job["start"][key]
                          for key in job["start"]}
    ref_grad = want["moment"]
    return {
        "target_rel_l1": compare.rel_l1(got_target, want_target),
        "loss_rel_gap": max(abs(g - w) / abs(w) for g, w in zip(
            got["losses"][:CHECKED_STEPS], want["losses"])),
        "grad_norm_gap": compare.leaf_norm_gaps(got["moment"], ref_grad,
                                                ref_grad),
        "change_norm_gap": compare.leaf_norm_gaps(change(got), change(want),
                                                  ref_grad),
    }
