"""``bench.py``'s deep512 (``entry.deep512_setup``: the mesh bench scene,
path/MIS to depth 8, ``render()`` with ``cfg.compact``) on the CPU at
small sizes: the compacted film against the full wavefront's and against
the benchmark's plain reference (``gpubench/reference/deep.py``) bit for
bit, its per-depth alive counts against the reference's, the
``mesh.deep512`` configuration against the entry, and the compacted
route's spans and counters; the compaction's kernels as
``compact_ms.deep`` reads them from a profiler's trace. The ``cuda`` tests
hold the compacted film to the kept full wavefront on the card and read
the compaction's kernels from a trace of the card."""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.utils import metrics
from gpubench import cells, harness, scenes
from gpubench.reference import deep, textured
from gpubench.traffic import deep_frames

RES = 16
SMALL = {"mesh": {"params": {"subdiv": 3}}, "accel": {"capacity": 16}}
COMPACT = ("crt.compact.order", "crt.compact.gather", "crt.compact.scatter")


def _config():
    return harness.merge(cells.config("deep512_mesh327k"), SMALL)


def _cell():
    return harness.merge(cells.cell("mesh.deep512"),
                         {"view": {"render": {"resolution": [RES, RES],
                                              "spp": 2}}})


@pytest.fixture(scope="module")
def deep16():
    """(port scene, reference scene, config, cell) at the small size."""
    config = _config()
    arrays = scenes.mesh_arrays(config)
    port = deep_frames.port_namespace(config)
    ref = scenes.namespace(scenes.REFERENCE)
    return (scenes.build_scene(port, config, arrays, "cpu"),
            deep.untextured(scenes.build_scene(ref, config, arrays, "cpu")),
            config, _cell())


def _view(config, cell, seed):
    return scenes.view(deep_frames.port_namespace(config), config, cell,
                       seed=seed)


def _pass_counts(scene, camera, cfg, sample_idx=0):
    counts = []
    with torch.no_grad():
        integ.render_pass_compact(scene, camera, cfg, integ.make_filter(cfg),
                                  integ.make_sensor(cfg), sample_idx,
                                  alive_counts=counts)
    return counts


@pytest.mark.parametrize("seed", [5, 2**31 + 91])
def test_compacted_render_is_the_full_wavefront(deep16, seed):
    scene, _, config, cell = deep16
    camera, cfg = _view(config, cell, seed)
    assert cfg.compact and cfg.max_depth == 8 and cfg.sampler.kind == "sobol"
    film, _ = integ.render(scene, camera, cfg)
    full, _ = integ.render(scene, camera,
                           dataclasses.replace(cfg, compact=False))
    assert torch.equal(film.rgb_sum, full.rgb_sum)
    assert torch.equal(film.weight_sum, full.weight_sum)
    assert int(film.spp_done) == 2


@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_render_matches_the_plain_reference(deep16, seed):
    """The port's compacted film sums and resolved image equal the
    reference's full wavefront bit for bit."""
    scene, ts, config, cell = deep16
    camera, cfg = _view(config, cell, seed)
    film, sensor = integ.render(scene, camera, cfg)
    image = film.resolve(sensor)
    ref = scenes.namespace(scenes.REFERENCE)
    r_camera, r_cfg = scenes.view(ref, config, cell, seed=seed)
    r_sensor = ref.integ.make_sensor(r_cfg)
    rgb, wt = textured.path_film(ts, r_camera, r_cfg, r_sensor, None, 2)
    r_image = ref.film.Film(rgb[:, None], wt[:, None]).resolve(r_sensor)
    assert torch.equal(film.rgb_sum.reshape(-1, 3), rgb)
    assert torch.equal(film.weight_sum.reshape(-1), wt)
    assert torch.equal(image.reshape(-1, 3), r_image[:, 0])
    assert float(rgb.abs().sum()) > 0.0


@pytest.mark.parametrize("sample_idx", [0, 1])
def test_alive_counts_are_the_references(deep16, sample_idx):
    scene, ts, config, cell = deep16
    camera, cfg = _view(config, cell, 11)
    ref = scenes.namespace(scenes.REFERENCE)
    r_camera, r_cfg = scenes.view(ref, config, cell, seed=11)
    want = deep.alive_counts(ts, r_camera, r_cfg, sample_idx)
    got = _pass_counts(scene, camera, cfg, sample_idx)
    assert len(want) == 8 and want[0] == RES * RES and want[1] > 0
    assert got == want[:len(got)] and not any(want[len(got):])


def test_config_is_the_entry_deep512(deep16):
    """The configuration's scene, camera and RenderConfig (through the
    cell's namespace) are ``entry.deep512_setup``'s with compaction on."""
    scene, _, config, _ = deep16
    camera, cfg = scenes.view(deep_frames.port_namespace(config), config,
                              cells.cell("mesh.deep512"))
    base = entry.mesh327k_setup(512, 4, subdiv=3, cap=16, device="cpu")[0]
    e_scene, e_camera, e_cfg = entry.deep512_setup(base, 512, 4,
                                                   device="cpu")
    assert camera == e_camera
    assert cfg == dataclasses.replace(e_cfg, compact=True,
                                      compact_quantum=8192)
    ours, theirs = integ.scene_leaves(scene), integ.scene_leaves(e_scene)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b


def test_compaction_spans_and_counters(deep16):
    """Under a profiler: one crt.compact.sync a count read, one order,
    gather and scatter a bounce from depth 1, the alive counts in
    crt.bounce.alive over 8 x the pass's lanes; no device time off the
    card. Without a profiler: the sync spans alone, no counter."""
    scene, _, config, cell = deep16
    camera, cfg = _view(config, cell, 13)
    metrics.reset()
    counts = _pass_counts(scene, camera, cfg)
    names = [s["name"] for s in metrics.spans()]
    assert names == ["crt.compact.sync"] * len(counts)
    assert metrics.counters() == {}

    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        counts = _pass_counts(scene, camera, cfg)
    spans = metrics.spans()
    names = [s["name"] for s in spans]
    bounced = sum(1 for k in counts[1:] if k > 0)
    assert bounced >= 1
    assert names.count("crt.compact.sync") == len(counts)
    for name in COMPACT:
        assert names.count(name) == bounced
    assert all(s["device_ms"] is None for s in spans)
    got = metrics.counters()
    assert got["crt.bounce.alive"] == sum(counts)
    assert got["crt.bounce.lanes"] == cfg.max_depth * RES * RES


def _event(device, name, cid, start, end):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    return types.SimpleNamespace(
        device_type=cpu if device == "cpu" else cuda, name=name, id=cid,
        time_range=types.SimpleNamespace(start=start, end=end))


# A host range of the compaction (10-20 us) and one of another span
# (30-40 us), the launches inside them, and what each launched on the
# device; the profiler's device mirror of the range is no operation.
_TRACE = [_event("cpu", "crt.compact.gather", 0, 10.0, 20.0),
          _event("cpu", "crt.intersect", 0, 30.0, 40.0),
          _event("cpu", "cudaLaunchKernel", 7, 11.0, 12.0),
          _event("cpu", "cudaLaunchKernel", 8, 13.0, 14.0),
          _event("cpu", "cudaLaunchKernel", 9, 31.0, 32.0),
          _event("cpu", "aten::index", 9, 12.0, 13.0),
          _event("cuda", "crt.compact.gather", 0, 50.0, 90.0),
          _event("cuda", "index_kernel", 7, 50.0, 60.0),
          _event("cuda", "index_kernel", 8, 55.0, 70.0),
          _event("cuda", "traverse_kernel", 9, 80.0, 90.0)]


@pytest.mark.parametrize("names, busy", [
    (COMPACT, 20e-6),
    (("crt.intersect",), 10e-6),
    (("crt.compact.order",), None)])
def test_compaction_kernels_are_read_from_the_trace(names, busy):
    """``deep_frames.launched_in``, compact_ms.deep's reading: the union
    of the device intervals of the kernels launched inside the named host
    ranges (matched by correlation id), no other kernel, and None where
    no range holds a launch."""
    got = deep_frames.launched_in(_TRACE, names)
    assert got == pytest.approx(busy) if busy is not None else got is None


def _cuda_deep(res):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scene, camera, cfg = entry.deep512_setup(res=res, spp=4, device="cuda")
    return scene, camera, dataclasses.replace(cfg, compact=True,
                                              compact_quantum=8192)


@pytest.mark.cuda
def test_compacted_film_is_the_kept_full_wavefront_on_cuda():
    """At 64², depth 8, on the card: render() with compaction (eager
    compacted passes) gives the kept full wavefront's film bit for bit."""
    scene, camera, cfg = _cuda_deep(64)
    metrics.reset()
    film, _ = integ.render(scene, camera, cfg)
    full_cfg = dataclasses.replace(cfg, compact=False)
    integ.render(scene, camera, full_cfg)            # captures, keeps
    full, _ = integ.render(scene, camera, full_cfg)  # replays the kept pass
    assert metrics.counters().get("crt.graph.kept", 0) == 1
    assert torch.equal(film.rgb_sum, full.rgb_sum)
    assert torch.equal(film.weight_sum, full.weight_sum)


@pytest.mark.cuda
def test_compaction_kernels_in_the_trace_on_cuda():
    """Under a profiler on the card the kernels launched inside the
    crt.compact.* ranges carry device time in the trace, less than the
    pass's; every eager span, those included, keeps device_ms None."""
    scene, camera, cfg = _cuda_deep(64)
    integ.render(scene, camera, cfg, passes=1)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        integ.render(scene, camera, cfg, passes=1)
    events = prof.events()
    for name in COMPACT:
        assert deep_frames.launched_in(events, (name,)) > 0.0, name
    total = deep_frames.launched_in(events, COMPACT)
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(ev.time_range.end - ev.time_range.start for ev in events
               if ev.device_type == cuda) * 1e-6
    assert 0.0 < total < busy
    spans = metrics.spans()
    assert {s["name"] for s in spans} >= set(COMPACT)
    assert all(s["device_ms"] is None for s in spans)
