"""The ``mesh.deep512`` cell driven on the CPU at a small size (a 1,280
triangle mesh in an octree of leaf capacity 16, 32x32 frames, where a few
rays still enter depths 4-7): the port's compacted route against the
plain reference (``reference/deep.py``), bit for bit on CPU tensors; the
control; the faults that its check has to catch; and its per-layer
readers, which find nothing to read off the card."""

import dataclasses

import pytest
import torch

from gpubench import cells, compare, harness, scenes
from gpubench.reference import precision

CELL = "mesh.deep512"
OVER = {"view": {"render": {"resolution": [32, 32]}},
        "check": {"pixels": 96}}
CONF = {"mesh": {"params": {"subdiv": 3}}, "accel": {"capacity": 16}}
SEED = 2**31 + 4242


def small_run(trace=False):
    return harness.run(CELL, SEED, 0.5, trace, "cpu", override=OVER,
                       config_override=CONF)


def test_cell_matches_reference():
    out = small_run()
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_control_is_not_correct():
    cell = harness.merge(cells.cell(CELL), OVER)
    config = harness.merge(cells.config(cell["config"]), CONF)
    kind = cells.kind(cell["kind"])
    st = kind.setup(cell, config, "cpu")
    rec = kind.window(st, SEED, 1e-3, False)
    ref = scenes.namespace(scenes.REFERENCE)
    ref_scene = scenes.build_scene(ref, config, st.arrays, "cpu")
    correct, checks = compare.judge(
        kind.check(st, rec, SEED, ref, ref_scene, lowered=precision.lowered),
        cell["limits"])
    assert not correct, checks


def _faults():
    from computational_ray_tracer_tpu_torch.models import integrator
    acc, bounce = integrator.accumulate, integrator._bounce_step
    compact = integrator.render_pass_compact

    def one_pass(pass_fn, film, stop, *args, **kw):
        return acc(pass_fn, film, min(stop, 1), *args, **kw)

    def launch_order(scene, cfg, state, depth, pixel, *args):
        # the alive rays' pixel ids in launch order, not in the rays' order
        return bounce(scene, cfg, state, depth, torch.sort(pixel).values,
                      *args)

    def four_bounces(scene, camera, cfg, *args, **kw):
        return compact(scene, camera, dataclasses.replace(cfg, max_depth=4),
                       *args, **kw)

    return {"scatter back skipped": (integrator, "_BOUNCE_KEYS", (), None),
            "pixel ids in launch order": (integrator, "_bounce_step",
                                          launch_order, None),
            "loop stopped after depth 4": (integrator, "render_pass_compact",
                                           four_bounces, "alive_count_gap"),
            "one pass of the four": (integrator, "accumulate", one_pass,
                                     None)}


@pytest.mark.parametrize("case", list(_faults()))
def test_fault_is_not_correct(case, monkeypatch):
    """A run with the timed path broken underneath reads above a limit
    (the named one, where the fault names one)."""
    owner, attr, fn, number = _faults()[case]
    monkeypatch.setattr(owner, attr, fn)
    out = small_run()
    assert not out["correct"], out["checks"]
    if number is not None:
        check = out["checks"][number]
        assert check["value"] > check["limit"], out["checks"]


def test_readers_find_nothing_off_the_card():
    out = small_run(trace=True)
    assert out["correct"], out["checks"]
    new = set(cells.cell(CELL)["per_layer"])
    assert len(new) == 7 and not new & set(out["metrics"]), out["metrics"]
