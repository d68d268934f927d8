"""The port's ``utils/plot.py`` (Graph2D without matplotlib) and its eight
validation apps against the JAX package's, on the CPU at small sizes.

Each port app's report has the reference app's keys and its deterministic
entries equal the reference app's to ``chip_smoke.py`` phase 21's
tolerances (``app_report_diffs``); its statistical entries (other draws:
a ``torch.Generator`` where the reference takes a ``jax.random`` key) are
each within their own bound (``app_report_bounds``). Phase 21 itself runs
here with the CPU on both sides.
"""

import ast
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from computational_ray_tracer_tpu import apps as japps
from computational_ray_tracer_tpu_torch import apps as tapps
from computational_ray_tracer_tpu_torch.apps import __main__ as tcli
from computational_ray_tracer_tpu_torch.utils import image
from computational_ray_tracer_tpu_torch.utils import plot

from test_torch_octree import _smoke_on_host_clock

SMALL = {"filter_film_test": {"n": 4000}, "sampler_test": {"n": 5000},
         "montecarlo_test": {"n": 20000}, "polygon_app": {"n_vertices": 10},
         "crossbridge": {"n_steps": 400}}
VALIDATION_APPS = ("spectrum_color", "filter_film_test", "sampler_test",
                   "montecarlo_test", "polygon_app", "crossbridge", "ode_app",
                   "plotter_demo")


@pytest.fixture
def cs(monkeypatch):
    return _smoke_on_host_clock(monkeypatch)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch: the tier-1 run puts six workers on
    the cores, and each worker's full thread pool would oversubscribe them
    (the crossbridge's thousands of small steps ran 50x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_histogram_png_and_sidecar(tmp_path):
    rng = np.random.default_rng(4)
    s = rng.normal(0, 1, 5000)
    g = plot.Graph2D("title", "xl", "yl")
    g.plot_histogram(s, bins=40, range=(-3, 3), label="d")
    g.plot_histogram(s, bins=17, density=False, label="c")
    g.plot_function(np.cos, -3, 3, n=64, label="cos")
    g.plot_points([0.5, -1.0], [0.2, 0.1], label="pts", s=20)
    g.set_range(ymin=-0.5)
    path = g.save(os.path.join(tmp_path, "h.png"))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(image.decode_png(f.read()), g.render())
    with open(path + ".json") as f:
        side = json.load(f)
    assert (side["title"], side["xlabel"], side["ylabel"]) == (
        "title", "xl", "yl")
    assert side["size"] == [770, 550] and side["yrange"][0] == -0.5
    kinds = [(x["kind"], x["label"]) for x in side["series"]]
    assert kinds == [("histogram", "d"), ("histogram", "c"), ("line", "cos"),
                     ("points", "pts")]
    for series, kw in zip(side["series"][:2], (
            {"bins": 40, "range": (-3, 3), "density": True},
            {"bins": 17, "density": False})):
        h, e = np.histogram(s, **kw)
        np.testing.assert_array_equal(series["heights"], h)
        np.testing.assert_array_equal(series["edges"], e)
    x = np.linspace(-3, 3, 64)
    np.testing.assert_array_equal(side["series"][2]["x"], x)
    np.testing.assert_array_equal(side["series"][2]["y"], np.cos(x))
    assert side["series"][3]["x"] == [0.5, -1.0]
    # each series drew in its own colour
    img = g.render()
    for c in plot._COLORS[2:4]:
        assert np.all(img == c, axis=-1).any()


def test_plot_needs_no_matplotlib(monkeypatch, tmp_path):
    with open(plot.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n and n.startswith("matplotlib")]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    mod = importlib.reload(plot)
    mod.Graph2D().plot_line([0, 1], [1, 0]).save(
        os.path.join(tmp_path, "a.png"))
    assert os.path.exists(os.path.join(tmp_path, "a.png.json"))


def test_app_names_and_command_line(tmp_path, capsys):
    assert tapps.APP_NAMES == japps.APP_NAMES
    out = os.path.join(tmp_path, "demo")
    path = tcli.main(["plotter_demo", "--device", "cpu", "--out", out])
    assert path == os.path.join(out, "plotter_demo.png")
    assert os.path.exists(path + ".json")


@pytest.mark.parametrize("name", VALIDATION_APPS)
def test_app_matches_reference(name, cs, tmp_path):
    kw = SMALL.get(name, {})
    port = importlib.import_module(
        f"computational_ray_tracer_tpu_torch.apps.{name}")
    ref = importlib.import_module(f"computational_ray_tracer_tpu.apps.{name}")
    t_out, j_out = (os.path.join(tmp_path, k) for k in ("port", "ref"))
    got = port.main(t_out, device="cpu", **kw)
    want = ref.main(j_out, **kw)
    assert got is not None
    pngs = lambda d: sorted(f for f in os.listdir(d) if f.endswith(".png"))
    assert pngs(t_out) == pngs(j_out)
    assert sorted(f[:-len(".json")] for f in os.listdir(t_out)
                  if f.endswith(".png.json")) == pngs(t_out)
    for f in os.listdir(j_out):
        if not f.endswith(".png"):
            assert os.path.exists(os.path.join(t_out, f)), f
    if isinstance(want, dict):
        assert cs._keys(got) == cs._keys(want)
    cs.app_report_diffs(name, got, want)
    n = kw.get("n")
    for report in (got, want):
        cs.app_report_bounds(name, report, n, "cpu")
    assert cs.app_plots(t_out).keys() == set(pngs(t_out))


def test_apps_phase_runs_on_cpu(cs, capsys):
    """21 at small sizes with the CPU on both sides: every check it makes
    on the card."""
    launches = cs.apps_phase("cpu", "cpu", sizes=SMALL)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("phase21 ")]
    assert len(line) == 1
    row = json.loads(line[0][len("phase21 "):])
    assert row["apps"] == list(VALIDATION_APPS)
    assert row["crossbridge_steps"] == 400
    assert launches == row["launches"]
    assert row["card_vs_cpu_abs_diff"].keys() == {
        "spectrum_color", "filter_film_test", "montecarlo_test",
        "polygon_app", "crossbridge", "ode_app"}
    assert all(d == 0.0 for v in row["card_vs_cpu_abs_diff"].values()
               for d in v.values())
    assert set(row["seconds"]) == {f"{a}_{s}_s" for a in VALIDATION_APPS
                                   for s in ("card", "cpu")}
    # each swatch lookup of filter_film_test (3 sensors x 24) held to the
    # plain version on its own inputs: a (471, 3) table at 256 x 8 rows
    held = row["interp_held_to_plain"]
    assert held["calls"] == 72 and held["bitwise"]
    assert held["k_c_rows"] == [[471, 3, 2048]]
    assert held["max_abs_err"] == 0.0 and held["max_abs_value"] > 0.0
    ode = row["card_vs_cpu_abs_diff"]["ode_app"]
    assert {"ode.png.euler", "ode.png.rk2", "ode.png.rk4",
            "ode.png.analytic"} <= ode.keys()


def test_phase21_holds_the_ode_trajectories(cs, tmp_path):
    """A solver's trajectory off by more than rtol 1e-5 / atol 1e-6 fails
    the card-vs-CPU check; within it, it passes."""
    from computational_ray_tracer_tpu_torch.apps import ode_app
    ode_app.main(str(tmp_path), device="cpu")
    want = cs.app_plots(str(tmp_path))["ode.png"]
    got = json.loads(json.dumps(want))
    rk4 = [s for s in got["series"] if s["label"] == "rk4"][0]
    rk4["y"][60] += 5e-7
    d = cs.plot_series_diffs("ode_app", "ode.png", got, want)
    assert 4e-7 < d["ode.png.rk4"] < 6e-7 and d["ode.png.euler"] == 0.0
    rk4["y"][60] += 2e-5
    with pytest.raises(AssertionError, match="ode.png y"):
        cs.plot_series_diffs("ode_app", "ode.png", got, want)
    # RK4's float32 errors bound no order: the difference is printed only
    report = json.load(open(os.path.join(tmp_path, "ode.json")))
    other = json.loads(json.dumps(report))
    other["rk4"]["order"] += 3.0
    d = cs.app_report_diffs("ode_app", other, report)
    assert d["rk4.order_not_held"] == pytest.approx(3.0)
    assert "euler.order" in d and "rk4.order" not in d


def test_phase21_holds_each_interp_launch_to_plain(cs, monkeypatch):
    """The recorded launches are compared bitwise; one that differs in a
    single element fails the phase."""
    from computational_ray_tracer_tpu_torch.ops import interp_kernel as ik
    gen = np.random.default_rng(4)
    tables = torch.as_tensor(gen.normal(size=(471, 3)).astype(np.float32))
    i0 = torch.as_tensor(gen.integers(0, 470, 64).astype(np.int32))
    w = torch.as_tensor(gen.uniform(0, 1, 64).astype(np.float32))
    row = cs.interp_launch_checks([(tables, i0, w)] * 2)
    assert row["calls"] == 2 and row["k_c_rows"] == [[471, 3, 64]]
    plain = ik.dense_interp_plain

    def off_by_one_ulp(t, i, x):
        out = plain(t, i, x).clone()
        out[5, 1] = torch.nextafter(out[5, 1], torch.tensor(np.inf))
        return out

    monkeypatch.setattr(ik, "dense_interp", off_by_one_ulp)
    with pytest.raises(AssertionError, match="differs"):
        cs.interp_launch_checks([(tables, i0, w)])
