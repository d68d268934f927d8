"""The harness driven on the CPU at small sizes: the port's CPU route
against the frozen reference, the result line's keys, the control and the
faults that the check has to catch, and the command line without a card.
On CPU tensors every kernel wrapper of the port runs its plain version,
so the two sides agree bit for bit there."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from gpubench import harness
from gpubench.reference import precision

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL_MESH = {"mesh": {"params": {"target_tris": 3000}}}
FRAMES = {
    "cornell.frames": ({"view": {"render": {"resolution": [16, 16],
                                            "spp": 3}}}, None),
    "canonical.frames": ({"view": {"render": {"resolution": [24, 24],
                                              "spp": 4}},
                          "check": {"pixels": 96}}, SMALL_MESH),
}
INVERSE = {"view": {"render": {"resolution": [8, 8], "spp": 2}}, "steps": 4}
SEED = 2**31 + 12345
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def small_run(cell, seed=SEED, trace=False, seconds=0.5):
    if cell == "cornell.inverse":
        over, conf = INVERSE, None
    else:
        over, conf = FRAMES[cell]
    return harness.run(cell, seed, seconds, trace, "cpu", override=over,
                       config_override=conf)


@pytest.mark.parametrize("cell", list(FRAMES) + ["cornell.inverse"])
def test_port_matches_reference(cell):
    out = small_run(cell)
    assert list(out) == KEYS
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


def test_traced_line_keys():
    out = small_run("cornell.frames", trace=True)
    assert list(out) == KEYS
    assert "first_pass_ms.frames" in out["metrics"]
    assert "setup_s" not in out["metrics"]


def _frames_check(cell, **kw):
    from gpubench import cells, scenes
    over, conf = FRAMES.get(cell, (INVERSE, None))
    cell_d = harness.merge(cells.cell(cell), over)
    config = harness.merge(cells.config(cell_d["config"]), conf or {})
    kind = cells.kind(cell_d["kind"])
    st = kind.setup(cell_d, config, "cpu")
    rec = kind.window(st, SEED, 1e-3, False)
    ref = scenes.namespace(scenes.REFERENCE)
    ref_scene = scenes.build_scene(ref, config, st.arrays, "cpu")
    values = kind.check(st, rec, SEED, ref, ref_scene, **kw)
    return harness.compare.judge(values, cell_d["limits"])


@pytest.mark.parametrize("cell", ["cornell.frames", "canonical.frames",
                                  "cornell.inverse"])
def test_control_is_not_correct(cell):
    """The reference with its intermediates stored in bfloat16, put in
    the program's place, fails the check."""
    correct, checks = _frames_check(cell, lowered=precision.lowered)
    assert not correct, checks


def _faults():
    from computational_ray_tracer_tpu_torch.models import integrator, inverse
    acc, rp, loss_fn = (integrator.accumulate, integrator.render_pass,
                        inverse.make_loss_fn)

    def unchanged(pass_fn, film, stop, *args, **kw):
        return acc(pass_fn, film, min(stop, 1), *args, **kw)

    def half(pass_fn, film, stop, *args, **kw):
        return acc(pass_fn, film, max(stop // 2, 1), *args, **kw)

    def altered(scene, camera, cfg, filter_obj, sensor, sample_idx):
        rgb, wt = rp(scene, camera, cfg, filter_obj, sensor, sample_idx)
        return rgb * 1.05, wt

    def half_loss(camera, cfg, extract_insert, target):
        _, insert = extract_insert
        render_image, _ = inverse.make_render_fn(camera, cfg)
        h = target.shape[0] // 2
        return lambda p, s: ((render_image(insert(s, p))[:h] - target[:h])
                             ** 2).mean()

    def altered_loss(camera, cfg, extract_insert, target):
        f = loss_fn(camera, cfg, extract_insert, target)
        return lambda p, s: f(p, s) * 1.05

    return {
        ("cornell.frames", "state unchanged"): (integrator, "accumulate",
                                                unchanged),
        ("cornell.frames", "half the batch"): (integrator, "accumulate",
                                               half),
        ("cornell.frames", "answer altered"): (integrator, "render_pass",
                                               altered),
        ("cornell.inverse", "state unchanged"): (
            inverse.DeviceAdam, "step", lambda self: None),
        ("cornell.inverse", "half the batch"): (inverse, "make_loss_fn",
                                                half_loss),
        ("cornell.inverse", "answer altered"): (inverse, "make_loss_fn",
                                                altered_loss),
    }


@pytest.mark.parametrize("case", list(_faults()), ids=" / ".join)
def test_fault_is_not_correct(case, monkeypatch):
    """A run with the timed path broken underneath comes out not correct
    (one chip: no exchange between chips to leave out)."""
    owner, attr, fn = _faults()[case]
    monkeypatch.setattr(owner, attr, fn)
    out = small_run(case[0])
    assert not out["correct"], out["checks"]


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "cornell.frames",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card(cuda_card):
    """One short run of the Cornell cell on the card: correct, and the
    result line's last key is ``checks``."""
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "cornell.frames",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"], line


def _stand_in_card(monkeypatch):
    """run.py driven on a stand-in card: the harness runs on the CPU at
    the small sizes."""
    from gpubench import run
    real = harness.run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "card_power_limit", lambda: "")
    monkeypatch.setattr(
        harness, "run", lambda w, seed, s, trace, device, t0: real(
            w, seed, s, trace, "cpu", t0, *FRAMES[w]))
    return run


def test_command_prints_the_line_last(monkeypatch, capsys):
    """run.py's printing on a stand-in card: the result line last on
    standard output with exactly the contract's keys, ``checks`` last, and
    each number compared beside its limit as the last lines on standard
    error."""
    run = _stand_in_card(monkeypatch)
    assert run.main(["--workload", "cornell.frames", "--seed", str(SEED),
                     "--seconds", "0.5", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[0] for t in tail] == list(line["checks"])
    assert all(" limit " in t for t in tail)


@pytest.mark.parametrize("where", ["check", "reader"])
def test_jax_loaded_late_prints_no_result(where, monkeypatch, capsys):
    """A stand-in ``jax`` module that the output check or a per-layer
    reader loads, after the window, still stops the run: a non-zero exit,
    no result line, and the name on standard error."""
    from gpubench import cells
    run = _stand_in_card(monkeypatch)
    stub = types.ModuleType("jax")
    owner, attr = ((cells.kind("frames"), "check") if where == "check"
                   else (cells.metric("first_pass_ms.frames"), "read"))
    real = getattr(owner, attr)

    def loads_jax(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax", stub)
        return real(*args, **kw)

    monkeypatch.setattr(owner, attr, loads_jax)
    code = run.main(["--workload", "cornell.frames", "--seed", str(SEED),
                     "--seconds", "0.5",
                     "--trace", "1" if where == "reader" else "0"])
    out, err = capsys.readouterr()
    assert code != 0
    assert out.strip() == ""
    assert "jax" in err.strip().splitlines()[-1]
