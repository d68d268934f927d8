"""Deep frames: ``frames`` (one client renders whole frames through
``integrator.render`` in a closed loop, frame k's sampler seed drawn from
(--seed, k); set-up renders one frame of ``warmup_spp`` passes) on a
configuration whose ``compact`` key asks the port for compaction between
bounces. Its window, profiled span and end-to-end metric are
``frames``'s, on the port's namespace with that key in every
``RenderConfig`` it builds (:class:`CompactedIntegrator`): ``render()``
then runs ``render_pass_compact`` one eager pass a film update.

``compact`` (``enabled``, ``quantum``) is a key of its own, not a render
setting, which ``scenes.view`` would hand to the frozen copy as well: it
has no compaction, and bounces the full wavefront, whose values
compaction keeps. ``quantum`` is the reference's TPU bucket size and
changes nothing in the port.

The check (``check`` in the cell's file) draws ``frames`` of the window's
frames from the seed and, at ``pixels`` pixels drawn from the seed,
compares their film sums and resolved images with the plain reference's
(``reference/deep.py``), each by its relative L1 gap; and it re-runs the
first pass of the first such frame through the port's
``render_pass_compact`` (the timed function, before the program's scene is
released) for its alive count at each depth, against the reference's over
the same whole pass: ``alive_count_gap`` is the largest |port - reference|
over the depths from ``deep_from`` on, over the largest reference count
there (at least 1). A depth the port's pass did not reach counts 0."""

from __future__ import annotations

import time
import types

import torch

from gpubench import compare, profiling, scenes
from gpubench.reference import deep, textured
from gpubench.traffic import frames

window = frames.window
end_to_end = frames.end_to_end

# The port's fine spans around the compaction between bounces; each opens
# a profiler range of its name on the host.
COMPACT_RANGES = ("crt.compact.order", "crt.compact.gather",
                  "crt.compact.scatter")


def launched_in(events, names):
    """Device seconds, the union of their intervals, of the device
    operations launched inside a host range named in ``names``: a device
    operation shares its correlation id with the runtime call that launched
    it (a host event whose name starts with "cu"), and that call's start
    lies inside the range. None where the trace holds no such range or no
    device operation launched in one."""
    cpu = torch.autograd.DeviceType.CPU
    ranges, launches, dev = [], {}, []
    for ev in events:
        r = ev.time_range
        if ev.device_type != cpu:
            dev.append((r.start, r.end, ev.id, ev.name))
        elif ev.name in names:
            ranges.append((r.start, r.end))
        elif ev.name.startswith("cu"):
            launches[ev.id] = r.start
    inside = lambda t: any(s <= t <= e for s, e in ranges)
    spans = sorted((s, e) for s, e, cid, name in dev
                   if not name.startswith(("crt.", profiling.RANGE_PREFIX))
                   and cid in launches and inside(launches[cid]))
    if not spans:
        return None
    busy_us, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy_us + cur_e - cur_s) * 1e-6


def profile(st, seed, rec):
    """``frames.profile``'s profiled frame, its reduced trace with
    ``compact_busy_s``: the device seconds of what the compaction between
    bounces launched (:func:`launched_in` the port's ``crt.compact.*``
    ranges; None where the port opens none). Its own copy of
    ``frames.profile``, which returns only the reduced trace."""
    if st.device != "cuda":
        return None
    params = frames.frame_params(st.cell, st.config, seed,
                                 len(rec["frames"]))
    tracer = frames._Tracer(rec["passes"], True, ranges=True)
    tracer.sync()
    prof = profiling.start()
    tracer.enter("first_pass")
    t_call = time.perf_counter()
    frames.render_frame(st, params, progress=tracer)
    wall = time.perf_counter() - t_call
    prof.stop()
    out = profiling.reduce(prof, wall, profiling.RANGE_PREFIX + "replays")
    if out is not None:
        out["params"] = params
        out["compact_busy_s"] = launched_in(prof.events(), COMPACT_RANGES)
    return out


class CompactedIntegrator:
    """The port's integrator module with the configuration's compaction
    in every ``RenderConfig`` it builds; every other name is the module's
    own, looked up at each use."""

    def __init__(self, integ, compact):
        self._integ = integ
        self._compact = {"compact": bool(compact["enabled"]),
                         "compact_quantum": int(compact["quantum"])}

    def __getattr__(self, name):
        return getattr(self._integ, name)

    def RenderConfig(self, **kw):  # noqa: N802 (the module's class name)
        return self._integ.RenderConfig(**kw, **self._compact)


def port_namespace(config):
    """``scenes.namespace`` of the port with :class:`CompactedIntegrator`
    in place of its integrator module."""
    port = scenes.namespace(scenes.PORT)
    integ = CompactedIntegrator(port.integ, config["compact"])
    return types.SimpleNamespace(**dict(vars(port), integ=integ))


def setup(cell, config, device):
    port = port_namespace(config)
    arrays = scenes.mesh_arrays(config)
    st = frames.State(cell, config, device, port, arrays,
                      scenes.build_scene(port, config, arrays, device))
    frames.render_frame(st, frames.frame_params(cell, config, 0, 0),
                        cell["warmup_spp"])
    return st


def port_alive_counts(st, rec):
    """The alive count at each depth of the first pass of the check's
    first frame, re-run through the port's ``render_pass_compact`` on the
    program's scene; kept in ``rec``, so that the check reads them after
    :func:`release` has freed the scene."""
    if "alive_counts" not in rec:
        seed, focal = rec["frames"][rec["sample"][0]["k"]]["params"]
        camera, cfg = scenes.view(st.port, st.config, st.cell, focal, seed)
        integ = st.port.integ
        counts = []
        with torch.no_grad():
            integ.render_pass_compact(
                st.scene, camera, cfg, integ.make_filter(cfg),
                integ.make_sensor(cfg), 0, alive_counts=counts)
        rec["alive_counts"] = counts
    return rec["alive_counts"]


def release(st, rec):
    """The port's alive counts for the check, then the program's scene
    freed before the reference runs."""
    port_alive_counts(st, rec)
    frames.release(st, rec)


def count_gap(got, want, start):
    """max over the depths from ``start`` on of |got - want| over the
    largest of ``want`` there (at least 1); a depth missing from ``got``
    counts 0."""
    got = list(got) + [0] * (len(want) - len(got))
    gap = max(abs(g - w) for g, w in zip(got[start:], want[start:]))
    return gap / max(max(want[start:]), 1)


def reference_film(ref, ts, st, params, pixels):
    """(rgb_sum (P, 3), weight_sum (P,), resolved image (P, 3)) of the
    plain reference for one frame at the flat pixel ids ``pixels``."""
    seed, focal = params
    camera, cfg = scenes.view(ref, st.config, st.cell, focal, seed)
    sensor = ref.integ.make_sensor(cfg)
    with torch.no_grad():
        rgb, wt = textured.path_film(ts, camera, cfg, sensor, pixels,
                                     cfg.sampler.spp)
        image = ref.film.Film(rgb[:, None], wt[:, None]).resolve(sensor)
    return rgb, wt, image[:, 0]


def check(st, rec, seed, ref, ref_scene, lowered=None):
    """{number name: value}: the worst over the sampled frames of the
    film's and the resolved image's relative L1 gap to the reference, and
    the first sampled frame's ``alive_count_gap``. ``lowered`` (the
    control) puts the reference computed under that context in the
    program's place."""
    ts = deep.untextured(ref_scene)
    pixels = frames.check_pixels(st, seed)
    worst = {"rgb_rel_l1": 0.0, "weight_rel_l1": 0.0, "image_rel_l1": 0.0}
    for kept in rec["sample"]:
        params = rec["frames"][kept["k"]]["params"]
        want = reference_film(ref, ts, st, params, pixels)
        if lowered is None:
            film = kept["film"]
            got = (film.rgb_sum.reshape(-1, 3)[pixels],
                   film.weight_sum.reshape(-1)[pixels],
                   kept["image"].reshape(-1, 3)[pixels.cpu()])
        else:
            with lowered():
                got = reference_film(ref, ts, st, params, pixels)
        for name, g, w in zip(worst, got, want):
            worst[name] = max(worst[name], compare.rel_l1(g, w))
    seed0, focal = rec["frames"][rec["sample"][0]["k"]]["params"]
    camera, cfg = scenes.view(ref, st.config, st.cell, focal, seed0)
    want = deep.alive_counts(ts, camera, cfg, 0)
    if lowered is None:
        got = port_alive_counts(st, rec)
    else:
        with lowered():
            got = deep.alive_counts(ts, camera, cfg, 0)
    worst["alive_count_gap"] = count_gap(got, want,
                                         st.cell["check"]["deep_from"])
    return worst
