"""chip_smoke.py's training phases (9b, 14, 15, 24a) on CPU tensors at small
sizes, with the host clock in place of CUDA events: every check they make
on the card runs here against the plain versions, so a fault in the phases
themselves shows before a chip run."""

import numpy as np
import pytest
import torch

from test_torch_octree import _smoke_on_host_clock
from computational_ray_tracer_tpu_torch.ops import interp_kernel as ik


@pytest.fixture
def cs(monkeypatch):
    return _smoke_on_host_clock(monkeypatch)


@pytest.mark.parametrize("case", ["seeded", "one_table_row", "edges"])
def test_backward_case_holds_the_plain_backward(cs, capsys, case):
    """Phase 9b's case helper on CPU tensors: seeded rows, every row on
    table row 235 (case e), and case f's rows (edge_rows: i0 at 0, at K-2
    and outside the table, w at 0 and 1)."""
    rng = np.random.default_rng(1)
    n, c, k = 5000, 13, 471
    i0 = torch.tensor(rng.integers(0, k - 1, n).astype(np.int32))
    w = torch.tensor(rng.uniform(0, 1, n).astype(np.float32))
    g = cs.seeded_gradient(n, c, 3, "cpu")
    if case == "one_table_row":
        i0 = torch.full_like(i0, 235)
    elif case == "edges":
        g, i0, w, k = cs.edge_rows(4099, c, k, 4, "cpu")
        assert g.shape == (4099, c) and (i0 < 0).any() and (i0 > k - 2).any()
        assert (i0 == 0).sum() > 800 and (i0 == k - 2).sum() > 800
        assert (w == 0).any() and (w == 1).any()
    row = cs.interp_backward_case(case, g, i0, w, k)
    assert row["max_abs_err"] == 0.0 and row["run_to_run_bitwise"]
    assert row["bound_by"] == "bytes" and row["library_max_abs_diff"] < 1e-2
    assert "plan" not in row
    assert f'"case": "{case}"' in capsys.readouterr().out


def test_sensor_rows_are_the_apps_sensor_lookups():
    """Phase 9's case d input: phase 21's 2,048 visible wavelengths (256
    stratified u, 8 hero wavelengths each) as (i0, w) of the dense grid."""
    import chip_smoke as cs
    i0, w = cs.sensor_rows(2048, "cpu")
    assert i0.dtype == torch.int32 and i0.shape == w.shape == (2048,)
    assert int(i0.min()) >= 0 and int(i0.max()) <= 469
    assert float(w.min()) >= 0.0 and float(w.max()) <= 1.0
    assert len(torch.unique(i0)) > 350


def test_training_phases_run_on_cpu(cs, capsys):
    """14a/14b at config 5's small scale and 2 steps, 14c at 16x16, 14d
    at full size (32x32, 1,280 triangles) and 15 at 16x16."""
    launches, call, s_step = cs.config5_phase("cpu", "cpu", scale="small",
                                              steps=2)
    assert call is None and set(launches) >= {"interp_backward"}
    assert s_step > 0
    assert cs.headline_grad_phase("cpu", "cpu", res=16) is None
    cs.octree_grad_phase("cpu")
    cs.options_phase("cpu", res=16)
    out = capsys.readouterr().out
    for phase in ("phase14a", "phase14b", "phase14c", "phase14d",
                  "phase15_golden"):
        assert phase + " " in out
    assert out.count("phase15 ") == len(cs.RENDER_OPTIONS)
    assert ik.LAUNCHES_BACKWARD == 0


def test_step_launch_checks_run_on_cpu(monkeypatch):
    """Phase 24a's helper at config 5's small scale (32x32, spp 4, depth
    3; the plain version in place of the brute-force kernel's bare
    launch): one step of the card's form (DeviceAdam) records every call
    of the brute-force and interpolation wrappers (their plain versions
    here: 3 closest-hit and 3 any-hit calls and 2 interpolations a pass)
    and holds each to its plain version; the backward kernel's wrapper is
    called on the card only (the CPU's autograd differentiates the plain
    lerp)."""
    from test_torch_intersect import _smoke_on_host_clock as brute_on_host
    held = brute_on_host(monkeypatch).step_launch_checks("cpu", "small")
    assert {k: r["launches"] for k, r in held.items()} == {
        "mesh_intersect": 12, "mesh_anyhit": 12, "dense_interp": 8}
    assert all(r["max_abs_err"] == 0.0 for r in held.values())


def test_sharded_and_option_phases_run_on_cpu(cs, capsys, monkeypatch):
    """16 at 16x16 spp 4 (world size 1, then two gloo ranks of one thread
    each; every step eager on gloo, the routes' films, losses and
    parameters bit for bit) against a render() film with config 5 at its
    small scale, and 17 at 16x16 (the sobol_global draws bit for bit, the
    option and camera passes)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    from computational_ray_tracer_tpu_torch import entry
    from computational_ray_tracer_tpu_torch.models import integrator as integ
    scene, camera, cfg = entry.cornell_setup(16, 4, device="cpu")
    film, _ = integ.render(scene, camera, cfg, chunk=4)
    # 16c holds its two routes' parameters bit for bit, as on the card: the
    # CPU's backward sums in the order of its threads, so one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cs.sharded_phase("cpu", "cpu", film, 0.0, 0.0, res=16, spp=4,
                         scale="small")
    finally:
        torch.set_num_threads(threads)
    assert not torch.distributed.is_initialized()
    cs.options_card_phase("cpu", "cpu", res=16, spp=4, small=16)
    out = capsys.readouterr().out
    assert out.count("phase16a ") == 1 and '"bitwise": true' in out
    assert out.count("phase16b ") == len(cs.TWO_RANK_LAYOUTS)
    assert out.count("phase16c ") == 1 + len(cs.TWO_RANK_LAYOUTS)
    assert out.count("phase17a ") == 1
    assert out.count("phase17b ") == len(cs.NEW_OPTIONS)
    assert out.count("phase17c ") == 3 * len(cs.NEW_CAMERAS)
