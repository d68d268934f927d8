"""The port's span and counter recorder (utils/metrics.py) and the sites
that record into it, on the CPU: spans nest under their frame's or job's
root with its request id (the capture and the step graph stood in for by a
graph that runs its function at each replay), the ring drops its oldest,
a fine span does nothing while no profiler records, every span is a range
of the profiler's on the recorder's clock, ``metrics.trace`` writes the
spans beside its Chrome trace, and renders and an ``optimize`` run give
the same bits with a profiler recording as without. The ``cuda`` test
captures a pass while the profiler records, on the card."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models import inverse as inv
from computational_ray_tracer_tpu_torch.ops import camera as cam
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.utils import metrics

RES, SPP = 8, 3


class _Graph:
    """A stand-in for a CUDA graph on the CPU: the capture keeps the
    function (and a static output), each replay runs it."""

    def __init__(self):
        self.fn = self.out = None

    def replay(self):
        out = self.fn()
        if out is not None:
            self.out.copy_(out)

    def reset(self):
        self.fn = None


def _capture(graph, fn, pool=None):
    graph.fn, graph.out = fn, torch.zeros(())
    return graph.out, {}


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The pass and the train step captured into _Graph; the capture's
    device allocations read 3 / 1 before and 50 / 48 after."""
    allocs = iter([(3, 1), (50, 48)] * 8)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(graphs, "capture", _capture)
    monkeypatch.setattr(graphs, "device_allocs", lambda device: next(allocs))
    monkeypatch.setattr(graphs, "on_side_stream", lambda fn: fn())


@pytest.fixture
def cornell():
    return entry.cornell_setup(res=RES, spp=SPP, device="cpu")


def config5_small():
    """(start scene, camera, cfg, lr, target image) of config 5 at 8x8,
    Sobol spp 2, depth 2 on the CPU."""
    target, start, _, _, lr, _ = entry.config5_setup("full", "cpu")
    camera = cam.PerspectiveCamera.create((0, 0, -2.2), (RES, RES),
                                          fov_y=70.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(resolution=(RES, RES),
                             sampler=integ.SamplerConfig(kind="sobol", spp=2),
                             integrator="path", max_depth=2)
    render_image, _ = inv.make_render_fn(camera, cfg)
    with torch.no_grad():
        return start, camera, cfg, lr, render_image(target)


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


@torch.no_grad()
def _frame(scene, camera, cfg, capture):
    """``render()``'s frame through ``accumulate`` with ``capture``."""
    filt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
    return integ.accumulate(
        lambda i: integ.render_pass(scene, camera, cfg, filt, sensor, i),
        filmmod.Film.create(cfg.resolution, device=scene.device),
        cfg.sampler.spp, capture=capture)


def _optimize(start, camera, cfg, lr, target, steps, capture):
    ei = inv.albedo_and_emission_params(start)
    return inv._optimize(start, camera, cfg, ei, target, steps, lr, None,
                         capture=capture)


def test_spans_nest_under_frame_and_job(cornell, cpu_graphs):
    scene, camera, cfg = cornell
    metrics.reset()
    film = _frame(scene, camera, cfg, True)
    start, camera5, cfg5, lr, target = config5_small()
    _, _, losses = _optimize(start, camera5, cfg5, lr, target, 4, True)
    got = _by_name(metrics.spans())

    frame, = got["crt.frame"]
    assert frame["parent"] is None and frame["request"] == frame["id"]
    for name in ("crt.pass.eager", "crt.pass.capture", "crt.pass.release"):
        span, = got[name]
        assert (span["parent"], span["request"]) == (frame["id"], frame["id"])
        assert frame["start"] <= span["start"] <= span["end"] <= frame["end"]
    assert got["crt.pass.capture"][0]["attrs"] == {"device_allocs": 47,
                                                   "device_frees": 47}

    job, = got["crt.job"]
    assert job["parent"] is None and job["request"] == job["id"] != frame[
        "id"]
    # Steps 2 and 3 are replays after a replay: one host span each, from
    # the previous loss read back to their launch.
    hosts, launches = got["crt.step.host"], got["crt.step.launch"]
    assert len(hosts) == 2 and len(launches) == 3
    assert all((h["parent"], h["request"]) == (job["id"], job["id"])
               for h in hosts)
    assert [s["parent"] for s in launches] == [job["id"]] + [
        h["id"] for h in hosts]
    assert all(s["request"] == job["id"] for s in launches)
    assert all(h["start"] <= s["start"] <= s["end"] <= h["end"]
               for h, s in zip(hosts, launches[1:]))
    # The stand-in graphs give the eager loops' bits.
    eager, _ = integ.render(scene, camera, cfg)
    assert torch.equal(film.rgb_sum, eager.rgb_sum)
    assert torch.equal(film.weight_sum, eager.weight_sum)
    assert losses == _optimize(start, camera5, cfg5, lr, target, 4,
                               False)[2]


def test_ring_drops_its_oldest():
    rec = metrics.Recorder(size=8)
    with rec.span("outer", root=True):
        for k in range(19):
            with rec.span(f"s{k}"):
                pass
    kept = rec.spans()
    assert len(kept) == 8
    assert [s["name"] for s in kept] == [f"s{k}" for k in range(11, 19)]
    assert [s["id"] for s in kept] == list(range(13, 21))
    assert all(s["request"] == 1 and s["parent"] == 1 for s in kept)


def test_fine_span_without_profiler_does_nothing(monkeypatch, cornell):
    opened = []
    monkeypatch.setattr(metrics, "_RANGE",
                        lambda name: opened.append(name) or metrics._NOTHING)
    metrics.reset()
    assert metrics.fine_span("crt.sample") is metrics._NOTHING
    scene, camera, cfg = cornell
    integ.render(scene, camera, cfg, passes=1)
    assert {s["name"] for s in metrics.spans()} == {"crt.frame",
                                                    "crt.pass.eager"}
    assert opened == [] and metrics.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        integ.render(scene, camera, cfg, passes=1)
    assert {"crt.sample", "crt.intersect"} <= set(opened)


def _trace_events(path):
    with open(path) as fh:
        trace = json.load(fh)
    return trace["traceEvents"], int(trace.get("baseTimeNanoseconds", 0))


def _match(events, records, start, end):
    """Each record against the profiler's range of its name in the same
    order: start and end within 100 us."""
    ranges = _by_name(sorted(
        (e for e in events if e.get("ph") == "X"
         and e.get("name", "").startswith("crt.")), key=lambda e: e["ts"]))
    for name, recs in _by_name(sorted(records, key=start)).items():
        assert len(ranges[name]) == len(recs), name
        for e, r in zip(ranges[name], recs):
            assert abs(e["ts"] - start(r)) < 100, (name, e, r)
            assert abs(e["ts"] + e["dur"] - end(r)) < 100, (name, e, r)


def test_spans_are_profiler_ranges_on_its_clock(cornell, tmp_path):
    scene, camera, cfg = cornell
    integ.render(scene, camera, cfg, passes=1)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        integ.render(scene, camera, cfg, passes=2)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events, base = _trace_events(tmp_path / "t.json")
    records = metrics.spans()
    assert {"crt.frame", "crt.pass.eager", "crt.sample",
            "crt.intersect"} <= {r["name"] for r in records}
    off = metrics.RECORDER.offset_ns - base
    us = lambda t: (t * 1e9 + off) * 1e-3
    _match(events, records, lambda r: us(r["start"]), lambda r: us(r["end"]))
    counts = metrics.counters()
    frame = records[0]["request"]
    assert counts == metrics.counters(frame)
    assert counts["crt.bounce.lanes"] == 2 * cfg.max_depth * RES * RES
    assert RES * RES <= counts["crt.bounce.alive"] <= counts[
        "crt.bounce.lanes"]


def test_trace_writes_spans_beside_the_chrome_trace(cornell, tmp_path):
    scene, camera, cfg = cornell
    integ.render(scene, camera, cfg, passes=1)
    with metrics.trace("frame", str(tmp_path)):
        integ.render(scene, camera, cfg, passes=1)
    lines = [json.loads(line) for line in
             open(tmp_path / "frame.spans.jsonl")]
    assert lines and lines[0]["name"] == "crt.frame"
    assert set(lines[0]) == {"id", "name", "start_us", "end_us", "parent",
                             "request", "attrs", "device_ms"}
    assert all(r["request"] == lines[0]["id"] for r in lines)
    events, _ = _trace_events(tmp_path / "frame.json")
    _match(events, lines, lambda r: r["start_us"], lambda r: r["end_us"])


def test_profiler_changes_no_bits(cornell):
    scene, camera, cfg = cornell
    start, camera5, cfg5, lr, target = config5_small()
    runs = []
    for traced in (False, True):
        with (profile(activities=[ProfilerActivity.CPU]) if traced
              else contextlib.nullcontext()):
            film, _ = integ.render(scene, camera, cfg)
            _, params, losses = _optimize(start, camera5, cfg5, lr, target,
                                          3, False)
        runs.append((film, params, losses))
    (f0, p0, l0), (f1, p1, l1) = runs
    assert torch.equal(f0.rgb_sum, f1.rgb_sum)
    assert torch.equal(f0.weight_sum, f1.weight_sum)
    assert l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)


@pytest.mark.cuda
def test_pass_captured_under_profiler_on_cuda():
    """Needs a CUDA card and nvcc: the Cornell headline at 64x64, spp 6,
    rendered with a profiler recording (so the capture holds the fine
    spans' timing events) and without: the same films; the profiled
    frame's crt.sample, crt.intersect and crt.pass pairs resolve, the
    first two within the third; no crt range on the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a CUDA graph is captured only on the "
                    "card")
    scene, camera, cfg = entry.cornell_setup(res=64, spp=6, device="cuda")
    integ.render(scene, camera, cfg, passes=2)
    plain, _ = integ.render(scene, camera, cfg)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, _ = integ.render(scene, camera, cfg)
        torch.cuda.synchronize()
    assert torch.equal(plain.rgb_sum, traced.rgb_sum)
    assert torch.equal(plain.weight_sum, traced.weight_sum)
    got = _by_name(metrics.spans())
    ms = {name: [r["device_ms"] for r in got[name]
                 if r["device_ms"] is not None]
          for name in ("crt.sample", "crt.intersect", "crt.pass")}
    assert len(ms["crt.pass"]) == 1 and ms["crt.pass"][0] > 0, ms
    assert len(ms["crt.sample"]) >= 3 * cfg.max_depth, ms
    assert len(ms["crt.intersect"]) == 2 * cfg.max_depth, ms
    assert sum(ms["crt.sample"]) + sum(ms["crt.intersect"]) <= ms[
        "crt.pass"][0]
    counts = metrics.counters()
    assert 0 < counts["crt.bounce.alive"] <= counts["crt.bounce.lanes"]
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name.startswith("crt.")]
    assert on_device == []
