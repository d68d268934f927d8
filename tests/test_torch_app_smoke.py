"""chip_smoke.py's app phases (18, 19, 20) and phase 22 on CPU tensors at
small sizes, with the host clock in place of CUDA events: every check they
make on the card runs here, so a fault in the phases themselves shows
before a chip run."""

import json

import pytest

from test_torch_octree import _smoke_on_host_clock


@pytest.fixture
def cs(monkeypatch):
    return _smoke_on_host_clock(monkeypatch)


def _row(out, phase):
    lines = [ln for ln in out.splitlines() if ln.startswith(phase + " ")]
    assert len(lines) == 1
    return json.loads(lines[0][len(phase) + 1:])


def test_raytracer_phase_runs_on_cpu(cs, capsys):
    """18 at 16x16, spp 4: the app, its PNG read back, its metrics, and a
    run resumed from 2 passes equal to the straight one bit for bit."""
    cs.raytracer_phase("cpu", "cpu", spp=4, res=(16, 16))
    row = _row(capsys.readouterr().out, "phase18")
    assert row["spp"] == 4 and row["resumed_from"] == 2
    assert row["resumed_film_bitwise"] and row["s_per_pass_median"] > 0
    assert row["phase_s"] >= row["app_s"] + row["resume_app_s"]


def test_shape_phase_runs_on_cpu(cs, capsys):
    """19 at 16x16 with the CPU as both sides: every count equal, every
    normal and uv equal."""
    cs.shape_phase("cpu", "cpu", res=16)
    row = _row(capsys.readouterr().out, "phase19")
    assert row["octree_tests_total_cpu"] == \
        row["triangle_tests_total_card"]["mesh_octree"]
    for err in row["normals_uv_vs_cpu"].values():
        assert err["max_abs_diff"] == 0.0 and err["hit_mask_mismatches"] == 0


def test_scene_file_phase_runs_on_cpu(cs, capsys):
    """20 with the 1,280-triangle icosphere and a 20,480-triangle dragon
    stand-in at 16x16, one pass: the loaders agree, and the JSON scene's
    film equals the in-memory mesh's bit for bit."""
    cs.scene_file_phase("cpu", "cpu", subdiv=3, dragon_tris=6000, res=16,
                        passes=1)
    row = _row(capsys.readouterr().out, "phase20")
    assert row["triangles"] == 1280 and row["bitwise_vs_in_memory"]
    assert row["build_octree_s"] > 0


def test_api_phase_runs_on_cpu(monkeypatch, capsys):
    """22 at 16x16 with the CPU as both sides (the 1,280-triangle
    icosphere for the mesh headline; the plain version in place of the
    brute-force kernel's bare launch): alive fractions starting at 1 and
    falling, the li_* integrators and sample_light's two routes bitwise,
    every captured launch held to its plain version, launches counted."""
    from test_torch_intersect import _smoke_on_host_clock as brute_on_host
    cs = brute_on_host(monkeypatch)
    launches = cs.api_phase("cpu", "cpu", 0.5, res=16, spp=1,
                            cpu_res={"cornell": 8, "mesh": 8}, subdiv=3)
    row = _row(capsys.readouterr().out, "phase22")
    fr = row["cornell_alive_fractions"]
    assert fr[0] == 1.0 and fr[-1] < fr[0] and len(fr) == 4
    assert row["effective_rays_per_s"] == pytest.approx(
        16 * 16 * row["effective_rays_per_sample"] / 0.5)
    assert row["li_bitwise"] and row["sample_light_bitwise"]
    assert row["mesh_alive_fractions"] == [1.0]
    assert set(row["held_to_plain"]) == {
        "mesh_intersect", "mesh_anyhit", "octree_closest", "octree_anyhit",
        "dense_interp"}
    assert all(max(r) == 0 for rows in (row["cornell_rays_apart_vs_cpu"],
                                        row["mesh_rays_apart_vs_cpu"])
               for r in rows.values())
    assert launches == {k: 0 for k in launches}   # plain versions on the CPU
