"""The sharded cell (``traffic/sharded_frames.py``) on the CPU: four gloo
ranks (this process rank 0, three spawned) at 16x16, spp 4. The run is
correct with every rank holding rank 0's film; the control and a planted
fault (the sp offset dropped, so both sp ranks draw the same sample) are
not; a rank that exits early ends the run with an error, not a hang. Its
six per-layer readers against a synthetic recorder, and its entries in
BENCHMARK.json."""

import json
import multiprocessing
import os
import time
import types

import pytest
import torch

from gpubench import cells, harness, span_readers
from gpubench.reference import precision
from test_bench_layout import BENCH
from test_bench_spans import Recorder, span

CELL = "cornell.sharded4"
SMALL = {"view": {"render": {"resolution": [16, 16], "spp": 4}}}
SEED = 2**31 + 4321
METRICS = ["collective_ms.sharded", "rank_skew.sharded",
           "first_step_ms.sharded", "replay_ms.sharded",
           "device_idle.sharded", "kernels_per_step.sharded"]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def drop_sp_offset(rank):
    """The fault: every rank renders as if at sp coordinate 0."""
    from computational_ray_tracer_tpu_torch.parallel import sharding
    axis = sharding._axis

    def no_sp_offset(mesh, name):
        size, coord, group = axis(mesh, name)
        return size, 0 if name == "sp" else coord, group
    sharding._axis = no_sp_offset


def exit_after_warmup(rank):
    """Rank 3 exits at its second frame (the window's first)."""
    if rank != 3:
        return
    from computational_ray_tracer_tpu_torch.parallel import sharding
    real, calls = sharding.render_distributed, []

    def render_distributed(*args, **kw):
        calls.append(None)
        if len(calls) > 1:
            os._exit(7)
        return real(*args, **kw)
    sharding.render_distributed = render_distributed


def small_run(trace=False, **over):
    return harness.run(CELL, SEED, 0.3, trace, "cpu",
                       override=dict(SMALL, **over))


def _no_world_left():
    assert not torch.distributed.is_initialized()
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("trace", [False, True])
def test_four_ranks_match_reference(trace):
    """Correct, every rank's film rank 0's; the untraced line reports the
    end-to-end metrics, the traced one on the CPU only the eager step
    (nothing is captured or replayed on gloo)."""
    out = small_run(trace)
    assert list(out) == KEYS
    assert out["correct"], out["checks"]
    assert out["checks"]["rank_film_mismatch"]["value"] == 0
    assert out["device"]["count"] == 4 and out["attempted"] >= 1
    want = ({"first_step_ms.sharded"} if trace
            else {"samples_per_s", "setup_s"})
    assert set(out["metrics"]) == want, out["metrics"]
    _no_world_left()


def test_control_is_not_correct():
    """The reference with its intermediates stored in bfloat16, put in
    the program's place, fails a limit."""
    cell = harness.merge(cells.cell(CELL), SMALL)
    config = cells.config(cell["config"])
    kind = cells.kind(cell["kind"])
    st = kind.setup(cell, config, "cpu")
    rec = kind.window(st, SEED, 1e-3, False)
    kind.release(st, rec)
    from gpubench import scenes
    ref = scenes.namespace(scenes.REFERENCE)
    ref_scene = scenes.build_scene(ref, config, st.arrays, "cpu")
    values = kind.check(st, rec, SEED, ref, ref_scene,
                        lowered=precision.lowered)
    correct, checks = harness.compare.judge(values, cell["limits"])
    assert not correct, checks
    _no_world_left()


def test_dropped_sp_offset_is_not_correct():
    out = small_run(patch=drop_sp_offset)
    assert not out["correct"]
    rgb = out["checks"]["rgb_rel_l1"]
    assert rgb["value"] > rgb["limit"], out["checks"]
    _no_world_left()


def test_rank_that_exits_ends_the_run():
    """A rank gone after set-up: rank 0 raises within the test's time,
    and leaves no rank and no process group behind."""
    t0 = time.monotonic()
    with pytest.raises(Exception):
        small_run(patch=exit_after_warmup)
    assert time.monotonic() - t0 < 120.0
    _no_world_left()


def test_replay_kernels_counts_after_the_first_graph_launch():
    """Kernels that start at or after the first ``cudaGraphLaunch``, not
    copies, fills, the benchmark's ranges or NCCL's annotation; None in a
    frame with no graph launch."""
    from gpubench.traffic import sharded_frames

    def ev(name, start, cuda=True):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=start),
            device_type=(torch.autograd.DeviceType.CUDA if cuda
                         else torch.autograd.DeviceType.CPU))
    events = [ev("eager_kernel", 1), ev("cudaGraphLaunch", 5, False),
              ev("step_kernel", 6), ev("ncclDevKernel_AllReduce", 7),
              ev("Memcpy DtoD", 8), ev("Memset (Device)", 8),
              ev("nccl:all_reduce", 8), ev("gpubench.resolve", 9),
              ev("cudaGraphLaunch", 10, False), ev("step_kernel", 11)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert sharded_frames.replay_kernels(prof) == (3, 2)
    prof = types.SimpleNamespace(events=lambda: events[:1])
    assert sharded_frames.replay_kernels(prof) is None


# --- the readers, fed a synthetic recorder --------------------------------

def sharded_recorder():
    """Two window frames (eager + capture 100 + 50 and 120 + 70 ms), one
    before the window and the profiled frame after it, whose last replay
    stamped its step 9 ms and its collectives 1.5 + 2.5 ms."""
    s = 1e-3
    records = []
    for fid, t, eager, capture in [(10, 5.0, 999, 999), (20, 11.0, 100, 50),
                                   (30, 12.0, 120, 70), (40, 30.0, 1, 1)]:
        records += [span(fid, "crt.frame", t, t + 0.5, fid),
                    span(fid + 1, "crt.pass.eager", t, t + eager * s, fid),
                    span(fid + 2, "crt.pass.capture", t + 0.1,
                         t + 0.1 + capture * s, fid)]
    records += [span(45, "crt.pass", 30.2, 30.3, 40, device_ms=9.0),
                span(46, "crt.collective.sp", 30.2, 30.3, 40, device_ms=1.5),
                span(47, "crt.collective.dp", 30.2, 30.3, 40, device_ms=2.5),
                span(48, "crt.collective.sp", 30.0, 30.1, 40)]   # eager
    return Recorder(records)


RANKS = [{"crt.pass": 9.0, "crt.collective.sp": 1.5,
          "crt.collective.dp": 2.5},
         {"crt.pass": 9.0, "crt.collective.sp": 0.5,
          "crt.collective.dp": 0.5},
         {"crt.pass": 9.0, "crt.collective.sp": 1.0,
          "crt.collective.dp": 1.0},
         {"crt.pass": 9.0, "crt.collective.sp": 2.0,
          "crt.collective.dp": 2.0}]
CTX = types.SimpleNamespace(rec={"t_start": 10.0, "t_end": 20.0,
                                 "ranks": RANKS,
                                 "profile": {"busy_s": 0.3,
                                             "window_s": 0.4,
                                             "replay_kernels": 6000,
                                             "replays": 15}})
WANT = {"collective_ms.sharded": 4.0, "replay_ms.sharded": 9.0,
        "first_step_ms.sharded": 170.0,
        "rank_skew.sharded": 100.0 * (8.0 - 5.0) / 8.0,
        "device_idle.sharded": 25.0, "kernels_per_step.sharded": 400.0}


@pytest.mark.parametrize("name", METRICS)
def test_reader_values(monkeypatch, name):
    rec = sharded_recorder()
    monkeypatch.setattr(span_readers, "recorder", lambda: rec)
    assert cells.metric(name).read(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", METRICS)
def test_reader_none_when_nothing_recorded(monkeypatch, name):
    """None with an empty recorder, without one (a port that has none),
    and with spans but no ``crt.frame`` and ranks that report no
    collective (a port without the sharding spans)."""
    empty = types.SimpleNamespace(rec={
        "t_start": 10.0, "t_end": 20.0, "profile": None,
        "ranks": [{"crt.pass": 9.0}] * 4})
    no_frame = Recorder([r for r in sharded_recorder().records
                         if r["name"] != "crt.frame"])
    for recorder in (Recorder([]), None, no_frame):
        monkeypatch.setattr(span_readers, "recorder", lambda: recorder)
        assert cells.metric(name).read(empty) is None


def test_cell_metrics_in_the_benchmark():
    """The configuration, the cell and its six metrics are entries of
    BENCHMARK.json, and the cell reports samples_per_s there."""
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert cells.cell(CELL)["per_layer"] == METRICS
    for name in METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["layer"] == (
            "device" if name.startswith(("device_", "kernels_"))
            else "sharding")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["samples_per_s"]["workloads"]
    config = cells.config("cornell_box_dp2sp2")
    assert config["device_mesh"] == {"dp": 2, "sp": 2}
    base = cells.config("cornell_box")
    assert {k for k in base if base[k] != config.get(k)} == {
        "name", "source", "stands_for"}
    assert json.dumps(config["reduced"]) == "[]"
