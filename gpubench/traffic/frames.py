"""Frames: one client renders whole frames in a closed loop, the next
frame called when the last one's resolved image is on the host.

The cell's file sets the frame (``view``: resolution, spp and camera over
the configuration's) and what changes from frame to frame (``vary``):
``"sampler_seed"`` draws frame k's sampler seed from (--seed, k), so each
frame is an independent estimate; ``"focal_distance"`` draws frame k's
focal distance from (--seed, k) in ``focal_range``, a user pulling focus.
Set-up renders one frame of ``warmup_spp`` passes at the cell's shapes.

A frame goes through the port's own entry: ``integrator.render`` for a
configuration whose ``pass`` is ``"render"``, ``integrator.accumulate``
over ``entry.canonical_pass`` with capture on, as
``entry.canonical_render`` runs it, for ``"canonical"``. Each frame is
timed from its call to its resolved image on the host.

The check (``check`` in the cell's file) draws ``frames`` of the window's
frames from the seed and, at ``pixels`` pixels drawn from the seed (null:
every pixel), compares their film sums and resolved images with the plain
reference's, each by its relative L1 gap."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from gpubench import compare, profiling, scenes


@dataclasses.dataclass
class State:
    cell: dict
    config: dict
    device: str
    port: object
    arrays: tuple
    scene: object


def frame_params(cell, config, seed, k):
    """(sampler seed, focal distance or None) of frame k under --seed."""
    rng = np.random.default_rng([seed, k])
    if cell["vary"] == "sampler_seed":
        return int(rng.integers(0, 1 << 31)), None
    if cell["vary"] == "focal_distance":
        lo, hi = cell["focal_range"]
        return 0, float(rng.uniform(lo, hi))
    raise ValueError(f"unknown frame variation {cell['vary']!r}")


def spp(cell, config):
    return cell.get("view", {}).get("render", {}).get(
        "spp", config["render"]["spp"])


def pixels_of(cell, config):
    res = cell.get("view", {}).get("render", {}).get(
        "resolution", config["render"]["resolution"])
    return res[0] * res[1]


def setup(cell, config, device):
    port = scenes.namespace(scenes.PORT)
    arrays = scenes.mesh_arrays(config)
    st = State(cell, config, device, port, arrays,
               scenes.build_scene(port, config, arrays, device))
    render_frame(st, frame_params(cell, config, 0, 0), cell["warmup_spp"])
    return st


def render_frame(st, params, passes=None, progress=None):
    """(film, resolved image on the host) of one frame of the port."""
    seed, focal = params
    port = st.port
    camera, cfg = scenes.view(port, st.config, st.cell, focal, seed)
    stop = cfg.sampler.spp if passes is None else passes
    if st.config["pass"] == "canonical":
        sensor = port.sensor.PixelSensor.create()
        film = port.integ.accumulate(
            lambda i: port.entry.canonical_pass(st.scene, camera, cfg,
                                                sensor, i),
            port.film.Film.create(cfg.resolution, device=st.scene.device),
            stop, progress=progress,
            capture=st.scene.device.type == "cuda")
    else:
        film, sensor = port.integ.render(st.scene, camera, cfg,
                                         progress=progress, passes=stop)
    with record_function(profiling.RANGE_PREFIX + "resolve"):
        image = film.resolve(sensor).cpu()
    return film, image


class _Tracer:
    """The traced run's progress callback: a sync and a host time after
    the first pass (the eager pass and the capture), a CUDA event after
    every pass, and with ``ranges`` host ranges around the stages of the
    profiled frame."""

    def __init__(self, n_passes, cuda, ranges):
        self.n, self.cuda, self.ranges = n_passes, cuda, ranges
        self.t_first, self.events, self.open = None, [], None

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def enter(self, name):
        if self.ranges:
            self.open = record_function(profiling.RANGE_PREFIX + name)
            self.open.__enter__()

    def leave(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def __call__(self, i, film):
        if i == 0:
            self.sync()
            self.t_first = time.perf_counter()
            self.leave()
            self.enter("replays")
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        if i == self.n - 1:
            self.sync()
            self.leave()


def window(st, seed, seconds, trace):
    """Frames until ``seconds`` have passed (one at least), the frame in
    flight finished. The check's frames are a uniform sample of the
    window's, drawn from the seed as they come (a reservoir), so only they
    keep their film and image. With ``trace`` each frame has a tracer."""
    cuda = st.device == "cuda"
    n = spp(st.cell, st.config)
    m = st.cell["check"]["frames"]
    pick = np.random.default_rng([seed, compare.CHECK_STREAM])
    frames, sample = [], []
    t_start, cpu_start = time.perf_counter(), time.process_time()
    while not frames or time.perf_counter() - t_start < seconds:
        k = len(frames)
        params = frame_params(st.cell, st.config, seed, k)
        tracer = _Tracer(n, cuda, ranges=False) if trace else None
        t_call = time.perf_counter()
        film, image = render_frame(st, params, progress=tracer)
        t_done = time.perf_counter()
        frames.append({"k": k, "params": params, "t_call": t_call,
                       "t_done": t_done, "samples": n * pixels_of(
                           st.cell, st.config), "tracer": tracer})
        slot = k if k < m else int(pick.integers(k + 1))
        if slot < m:
            kept = {"k": k, "film": film, "image": image}
            sample[slot:slot + 1] = [kept]
        del film, image
    if cuda:
        torch.cuda.synchronize()
    return {"frames": frames, "sample": sample, "t_start": t_start,
            "t_end": time.perf_counter(),
            "cpu_s": time.process_time() - cpu_start, "passes": n,
            "attempted": len(frames), "failed": 0,
            "item_s": [f["t_done"] - f["t_call"] for f in frames]}


def profile(st, seed, rec):
    """The traced run's profiled span, after the window (the profiler
    slows the process for the rest of its life): the window's next frame,
    with host ranges around its first pass, its replays and its resolve.
    Returns the reduced trace with the frame's parameters (None off the
    card)."""
    if st.device != "cuda":
        return None
    params = frame_params(st.cell, st.config, seed, len(rec["frames"]))
    tracer = _Tracer(rec["passes"], True, ranges=True)
    tracer.sync()
    prof = profiling.start()
    tracer.enter("first_pass")
    t_call = time.perf_counter()
    render_frame(st, params, progress=tracer)
    wall = time.perf_counter() - t_call
    prof.stop()
    out = profiling.reduce(prof, wall, profiling.RANGE_PREFIX + "replays")
    if out is not None:
        out["params"] = params
    return out


def end_to_end(rec):
    return {"samples_per_s": sum(f["samples"] for f in rec["frames"])
            / (rec["t_end"] - rec["t_start"])}


def release(st, rec):
    """Free the program's scene before the reference runs."""
    st.scene = None


def reference_film(ref, ref_scene, st, params, pixels):
    """(rgb_sum (P, 3), weight_sum (P,), resolved image (P, 3)) of the
    plain reference for one frame at the flat pixel ids ``pixels``."""
    from gpubench.reference import passes
    seed, focal = params
    camera, cfg = scenes.view(ref, st.config, st.cell, focal, seed)
    sensor = ref.integ.make_sensor(cfg)
    film_fn = (passes.canonical_film if st.config["pass"] == "canonical"
               else passes.path_film)
    with torch.no_grad():
        rgb, wt = film_fn(ref_scene, camera, cfg, sensor, pixels,
                          cfg.sampler.spp)
        image = ref.film.Film(rgb[:, None], wt[:, None]).resolve(sensor)
    return rgb, wt, image[:, 0]


def check_pixels(st, seed):
    """The flat pixel ids compared, drawn from the seed (every pixel where
    the cell's check names no count)."""
    total = pixels_of(st.cell, st.config)
    count = st.cell["check"].get("pixels")
    pix = (np.arange(total) if not count else np.sort(
        np.random.default_rng([seed, compare.CHECK_STREAM, 1]).choice(
            total, size=count, replace=False)))
    return torch.as_tensor(pix, dtype=torch.int64, device=st.device)


def check(st, rec, seed, ref, ref_scene, lowered=None):
    """{number name: value}: the worst over the sampled frames of the
    film's and the resolved image's relative L1 gap to the reference.
    ``lowered`` (the control) puts the reference computed under that
    context in the program's place."""
    pixels = check_pixels(st, seed)
    worst = {"rgb_rel_l1": 0.0, "weight_rel_l1": 0.0, "image_rel_l1": 0.0}
    for kept in rec["sample"]:
        params = rec["frames"][kept["k"]]["params"]
        want = reference_film(ref, ref_scene, st, params, pixels)
        if lowered is None:
            film = kept["film"]
            got = (film.rgb_sum.reshape(-1, 3)[pixels],
                   film.weight_sum.reshape(-1)[pixels],
                   kept["image"].reshape(-1, 3)[pixels.cpu()])
        else:
            with lowered():
                got = reference_film(ref, ref_scene, st, params, pixels)
        for name, g, w in zip(worst, got, want):
            worst[name] = max(worst[name], compare.rel_l1(g, w))
    return worst
