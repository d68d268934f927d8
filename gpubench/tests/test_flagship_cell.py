"""The ``mesh.flagship`` cell driven on the CPU at a small size (a 1,280
triangle mesh in an octree of leaf capacity 16, 16x16 frames): the port
against the plain reference of the textured octree scene
(``reference/textured.py``), bit for bit on CPU tensors; the control; the
faults that its check has to catch; and its per-layer readers, which find
nothing to read off the card."""

import pytest

from gpubench import cells, compare, harness, scenes
from gpubench.reference import precision

CELL = "mesh.flagship"
OVER = {"view": {"render": {"resolution": [16, 16]}},
        "check": {"pixels": 96}}
CONF = {"mesh": {"params": {"subdiv": 3}}, "accel": {"capacity": 16}}
SEED = 2**31 + 4242


def small_run(trace=False):
    return harness.run(CELL, SEED, 0.5, trace, "cpu", override=OVER,
                       config_override=CONF)


def _check(**kw):
    cell = harness.merge(cells.cell(CELL), OVER)
    config = harness.merge(cells.config(cell["config"]), CONF)
    kind = cells.kind(cell["kind"])
    st = kind.setup(cell, config, "cpu")
    rec = kind.window(st, SEED, 1e-3, False)
    ref = scenes.namespace(scenes.REFERENCE)
    ref_scene = scenes.build_scene(ref, config, st.arrays, "cpu")
    return compare.judge(kind.check(st, rec, SEED, ref, ref_scene, **kw),
                         cell["limits"])


def test_cell_matches_reference():
    out = small_run()
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_control_is_not_correct():
    correct, checks = _check(lowered=precision.lowered)
    assert not correct, checks


def _faults():
    from computational_ray_tracer_tpu_torch.models import integrator
    acc, occluded = integrator.accumulate, integrator.scene_occluded

    def one_pass(pass_fn, film, stop, *args, **kw):
        return acc(pass_fn, film, min(stop, 1), *args, **kw)

    def never(*args, **kw):
        return occluded(*args, **kw) & False

    return {"texture dropped": (integrator, "_tex_coeffs",
                                lambda scene, si: None),
            "shadows never occluded": (integrator, "scene_occluded", never),
            "one pass of the four": (integrator, "accumulate", one_pass)}


@pytest.mark.parametrize("case", list(_faults()))
def test_fault_is_not_correct(case, monkeypatch):
    """A run with the timed path broken underneath reads above a limit."""
    owner, attr, fn = _faults()[case]
    monkeypatch.setattr(owner, attr, fn)
    out = small_run()
    assert not out["correct"], out["checks"]


def test_readers_find_nothing_off_the_card():
    out = small_run(trace=True)
    assert out["correct"], out["checks"]
    new = set(cells.cell(CELL)["per_layer"])
    assert len(new) == 5 and not new & set(out["metrics"]), out["metrics"]
