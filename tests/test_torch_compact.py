"""The port's compacted path/MIS pass and its deep-render workloads against
the full wavefront and the JAX reference: render_pass_compact against
render_pass (Cornell and a small octree scene) and against the JAX
render_pass_compact, render() accumulating the same film, the flagship
pass at subdiv 3 against the JAX pass built with bench.py's arguments, and
the canonical pass on a small culled mesh against benchmarks/canonical.py's
make_pass, each scene carried across with convert.scene_from_numpy."""

import dataclasses
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _cornell_setup
from test_torch_render import export_scene
from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.models.scene import Scene as JScene
from computational_ray_tracer_tpu.ops import camera as jcam
from computational_ray_tracer_tpu.ops import color as jcolor
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
from computational_ray_tracer_tpu_torch.utils import mesh_gen as tmesh_gen

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))


def _close_to_full(scene, camera, cfg, sample_idx):
    """render_pass_compact against render_pass at the tolerance of
    tests/test_compaction.py; returns the per-depth alive counts."""
    flt, sensor = tinteg.make_filter(cfg), tsen.PixelSensor.create()
    counts = []
    rgb_c, wt_c = tinteg.render_pass_compact(scene, camera, cfg, flt, sensor,
                                             sample_idx, counts)
    rgb_f, wt_f = tinteg.render_pass(scene, camera, cfg, flt, sensor,
                                     sample_idx)
    np.testing.assert_allclose(wt_c.numpy(), wt_f.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(rgb_c.numpy(), rgb_f.numpy(), rtol=1e-4,
                               atol=1e-5)
    return counts


def _jax_close(got, ref):
    """The tolerance of tests/test_torch_render.py's render_pass test."""
    rgb, wt = (np.asarray(x) for x in ref)
    assert np.isfinite(got[0].numpy()).all()
    np.testing.assert_allclose(got[1].numpy(), wt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), rgb, rtol=0,
                               atol=2e-3 * max(float(rgb.max()), 1e-3))


@pytest.mark.parametrize("sample_idx", [0, 1])
def test_compact_matches_full_cornell(sample_idx):
    scene, camera, cfg = entry.cornell_setup(32, 4, device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=6)
    counts = _close_to_full(scene, camera, cfg, sample_idx)
    assert counts[0] == 32 * 32 and counts[-1] < counts[0]


def test_compact_matches_full_octree_scene():
    """tests/test_compaction.py's small octree scene."""
    v, f, uv = tmesh_gen.displaced_icosphere(2)
    from computational_ray_tracer_tpu_torch.models.scene import Scene
    from computational_ray_tracer_tpu_torch.ops import camera as tcam
    from computational_ray_tracer_tpu_torch.ops import triangle as ttri
    mesh = ttri.MeshData.build(v, f, uvs=uv)
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.6, 0.5)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1, 1, 1), "scale": 4.0},
                {"kind": "ambient", "spd_named": "stdillum-D65",
                 "scale": 0.2}],
        mesh=(mesh, np.zeros(mesh.n_triangles, np.int64)), use_octree=True,
        device="cpu")
    camera = tcam.PerspectiveCamera.create((0, 0.5, -3.4), (16, 16),
                                           fov_y=40.0, look_at=(0, 0, 0))
    cfg = tinteg.RenderConfig(
        resolution=(16, 16),
        sampler=tinteg.SamplerConfig(kind="independent", spp=2),
        integrator="path", max_depth=4)
    counts = _close_to_full(scene, camera, cfg, 0)
    assert counts[0] == 256 and 0 < counts[1] < 256


def test_compact_matches_jax_compact():
    """The port's compacted pass against the JAX render_pass_compact on
    bit-identical Cornell scene parameters."""
    jscene, jcamera, _ = _cornell_setup(res=32, spp=4, use_pallas=True)
    jcfg = jinteg.RenderConfig(
        resolution=(32, 32), sampler=jinteg.SamplerConfig(kind="sobol",
                                                          spp=4),
        integrator="path", max_depth=6, compact=True, compact_quantum=128)
    ref = jinteg.render_pass_compact(jscene, jcamera, jcfg,
                                     jinteg.make_filter(jcfg),
                                     jinteg.make_sensor(jcfg), jnp.uint32(1))
    tscene = convert.scene_from_numpy(export_scene(jscene), device="cpu")
    _, tcamera, tcfg = entry.cornell_setup(32, 4, device="cpu")
    tcfg = dataclasses.replace(tcfg, max_depth=6)
    got = tinteg.render_pass_compact(tscene, tcamera, tcfg,
                                     tinteg.make_filter(tcfg),
                                     tsen.PixelSensor.create(), 1)
    _jax_close(got, ref)


def test_render_honors_compact_flag(monkeypatch):
    """render() runs the full wavefront (the faster path on the card, with
    no compaction option), one render_pass per sample, and its film equals
    the compacted passes' accumulation."""
    scene, camera, cfg = entry.cornell_setup(16, 2, device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=5)
    assert not hasattr(cfg, "compact")
    flt, sensor = tinteg.make_filter(cfg), tsen.PixelSensor.create()
    compacted = [tinteg.render_pass_compact(scene, camera, cfg, flt, sensor,
                                            i) for i in range(2)]
    calls = []
    real = tinteg.render_pass
    monkeypatch.setattr(tinteg, "render_pass",
                        lambda *a: calls.append(a) or real(*a))
    film, _ = tinteg.render(scene, camera, cfg, chunk=2)
    assert len(calls) == 2 and film.spp_done == 2
    np.testing.assert_allclose(
        film.rgb_sum.numpy(),
        sum(rgb * wt[..., None] for rgb, wt in compacted).numpy(),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(film.weight_sum.numpy(),
                               sum(wt for _, wt in compacted).numpy(),
                               rtol=1e-4, atol=1e-6)


def _jax_flagship(res, subdiv):
    """bench.py's bench_flagship scene, camera and config at a small size
    (its _dragon_scene, textured with checker_texture(256))."""
    v, f, uv = jmesh_gen.displaced_icosphere(subdiv)
    mesh = jtri.MeshData.build(v, f, uvs=uv)
    scene = JScene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.75, 0.71, 0.62)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1.0, 1.0, 1.0), "scale": 4.0},
                {"kind": "ambient", "spd_named": "stdillum-D65",
                 "scale": 0.15}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, octree_capacity=192)
    img = jnp.asarray(np.asarray(jmesh_gen.checker_texture(256), np.float32))
    tex = jcolor.RGBToSpectrumTable.srgb().lookup(
        img.reshape(-1, 3)).reshape(*img.shape)
    mats = dataclasses.replace(
        scene.materials, use_texture=jnp.ones_like(scene.materials.use_texture))
    scene = dataclasses.replace(scene, texture=tex, materials=mats)
    camera = jcam.PerspectiveCamera.create(
        (0, 0.5, -3.4), (res, res), fov_y=40.0, look_at=(0, 0, 0),
        lens_radius=0.02, focal_distance=3.4)
    cfg = jinteg.RenderConfig(
        resolution=(res, res),
        sampler=jinteg.SamplerConfig(kind="stratified", spp=4, xs=2, ys=2),
        integrator="path", max_depth=4, filter_name="gaussian",
        filter_radius=(0.5, 0.5), compact=True, compact_quantum=8192)
    return scene, camera, cfg


def test_flagship_pass_matches_jax():
    """The flagship's compacted pass at subdiv 3, 32x32: the port's own
    flagship_setup scene and the JAX scene carried across both against
    the JAX render_pass_compact; the port's pass against its full
    wavefront."""
    jscene, jcamera, jcfg = _jax_flagship(32, 3)
    ref = jinteg.render_pass_compact(jscene, jcamera, jcfg,
                                     jinteg.make_filter(jcfg),
                                     jinteg.make_sensor(jcfg), jnp.uint32(2))
    assert float(np.asarray(ref[0]).max()) > 0.05
    m_scene, _, _ = entry.mesh327k_setup(32, 4, subdiv=3, device="cpu")
    tscene, tcamera, tcfg = entry.flagship_setup(32, 4, scene=m_scene,
                                                 device="cpu")
    assert tcfg.sampler.kind == "stratified"
    with pytest.raises(ValueError):
        entry.flagship_setup(32, 8, scene=m_scene, device="cpu")
    carried = convert.scene_from_numpy(export_scene(jscene), device="cpu")
    for scene in (carried, tscene):
        got = tinteg.render_pass_compact(scene, tcamera, tcfg,
                                         tinteg.make_filter(tcfg),
                                         tsen.PixelSensor.create(), 2)
        _jax_close(got, ref)
    _close_to_full(tscene, tcamera, tcfg, 2)


def test_deep512_setup_matches_bench():
    m_scene, _, _ = entry.mesh327k_setup(16, 2, subdiv=2, device="cpu")
    scene, camera, cfg = entry.deep512_setup(scene=m_scene, res=16,
                                             device="cpu")
    assert (cfg.max_depth, cfg.sampler.kind, cfg.sampler.spp) == (8, "sobol",
                                                                 2)
    assert camera.lens_radius == 0.0 and scene.packed_octree is not None
    counts = _close_to_full(scene, camera, cfg, 0)
    assert len(counts) >= 2 and counts[0] == 256


def test_canonical_pass_matches_jax():
    """canonical_pass on a small culled mesh in the canonical frame against
    benchmarks/canonical.make_pass on the same scene, carried across; the
    port's own canonical_setup renders the same image."""
    import canonical
    v, f, uv = jmesh_gen.dragon_stand_in(target_tris=6000)
    vw = np.asarray(v, np.float32) * 5.0 + np.asarray([0, -40, 800],
                                                      np.float32)
    mesh = jtri.MeshData.build(vw, f, uvs=uv)
    jscene = JScene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.5, 0.5, 0.5)}],
        lights=[{"kind": "distant", "direction": (0, 0, 1),
                 "rgb": (1.0, 1.0, 1.0), "scale": 1.0}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, octree_capacity=40,
        backface_cull_dir=(0.0, 0.0, 1.0))
    one_pass, _ = canonical.make_pass(jscene, 32, 4)
    carried = convert.scene_from_numpy(export_scene(jscene), device="cpu")
    own, camera, cfg = entry.canonical_setup(32, 4, mesh=(v, f, uv),
                                             device="cpu")
    assert torch.equal(own.tri_mask, carried.tri_mask)
    sensor = tsen.PixelSensor.create()
    for s in (0, 3):
        ref = one_pass(jscene, jnp.uint32(s))
        assert float(np.asarray(ref[0]).max()) > 0.05
        for scene in (carried, own):
            _jax_close(entry.canonical_pass(scene, camera, cfg, sensor, s),
                       ref)
