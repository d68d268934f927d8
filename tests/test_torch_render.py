"""The port's slice end to end against the JAX reference: materials and
lights on the same inputs, one render_pass of the Cornell + sphere scene
carried across with convert.scene_from_numpy, the port's own Scene.build +
render() against the checked-in golden, and the no-jax import rule."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _cornell_setup
from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.models import lights as jlgt
from computational_ray_tracer_tpu.models import materials as jmat
from computational_ray_tracer_tpu.ops import spectrum as jspec
from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.models import lights as tlgt
from computational_ray_tracer_tpu_torch.models import materials as tmat
from computational_ray_tracer_tpu_torch.models.scene import Scene
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
from computational_ray_tracer_tpu_torch.ops import spectrum as tspec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
T = lambda a: torch.tensor(np.asarray(a))


def export_scene(scene):
    """A JAX Scene's leaves as the numpy dict convert.scene_from_numpy
    takes."""
    a = {"wr": scene.wr}
    for k in tmat.FIELDS:
        a["materials." + k] = np.asarray(getattr(scene.materials, k))
    for k in tlgt.FIELDS:
        a["lights." + k] = np.asarray(getattr(scene.lights, k))
    if scene.spheres is not None:
        for k in convert.SPHERE_FIELDS:
            a["spheres." + k] = np.asarray(getattr(scene.spheres, k))
        a["sphere_mat"] = np.asarray(scene.sphere_mat)
    if scene.mesh is not None:
        for k in convert.MESH_FIELDS:
            a["mesh." + k] = np.asarray(getattr(scene.mesh, k))
        a["mesh_tri_mat"] = np.asarray(scene.mesh_tri_mat)
        a["tri_mask"] = (None if scene.tri_mask is None
                         else np.asarray(scene.tri_mask))
    if scene.octree is not None:
        for k in convert.OCTREE_FIELDS:
            a["octree." + k] = np.asarray(getattr(scene.octree, k))
    if scene.texture is not None:
        a["texture"] = np.asarray(scene.texture)
    return a


@pytest.fixture(scope="module")
def cornell32():
    scene, camera, cfg = _cornell_setup(res=32, spp=2, use_pallas=True)
    return scene, camera, cfg, convert.scene_from_numpy(export_scene(scene),
                                                        device="cpu")


@pytest.mark.parametrize("sample_idx", [0, 1])
def test_render_pass_matches_jax(cornell32, sample_idx):
    """Port render_pass vs the JAX render_pass (Pallas brute kernel in
    interpret mode) on bit-identical scene parameters; atol 2e-3*max as the
    golden tests."""
    jscene, jcamera, jcfg, tscene = cornell32
    f, s = jinteg.make_filter(jcfg), jinteg.make_sensor(jcfg)
    rj, wj = jax.jit(lambda sc, i: jinteg.render_pass(
        sc, jcamera, jcfg, f, s, i))(jscene, jnp.uint32(sample_idx))
    _, tcamera, tcfg = entry.cornell_setup(res=32, spp=2, device="cpu")
    rt, wt = tinteg.render_pass(tscene, tcamera, tcfg,
                                tinteg.make_filter(tcfg),
                                tsen.PixelSensor.create(), sample_idx)
    rj, wj = np.asarray(rj), np.asarray(wj)
    assert rt.shape == (32, 32, 3) and np.isfinite(rt.numpy()).all()
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                               atol=2e-3 * max(float(rj.max()), 1e-3))


def _golden4_spectral():
    """Golden config4 of tests/test_golden.py built with the port: gold and
    dielectric spheres under a 2856 K blackbody distant light."""
    from computational_ray_tracer_tpu.ops import spectra_data as jdata
    from computational_ray_tracer_tpu_torch.ops import camera as tcam
    from computational_ray_tracer_tpu_torch.ops import shapes as tshp
    bb = np.asarray(jspec.BlackbodySpectrum(2856.0)(
        jnp.asarray(jdata.DENSE_LAMBDA, jnp.float32))) * 100.0
    scene = Scene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.7, 0.7)},
                   {"kind": "conductor", "albedo_rgb": (1, 1, 1),
                    "metal": "metal-Au"},
                   {"kind": "dielectric", "albedo_rgb": (1, 1, 1),
                    "eta": 1.5}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "spd_dense": bb, "scale": 0.5}],
        spheres=[{"radius": 0.8, "material": i,
                  "transform": tshp.make_transform((x, 0, 0))}
                 for i, x in enumerate((-1.8, 0.0, 1.8))],
        device="cpu")
    camera = tcam.PerspectiveCamera.create((0, 0.8, -4.5), (32, 32),
                                           fov_y=45.0, look_at=(0, 0, 0))
    cfg = tinteg.RenderConfig(
        resolution=(32, 32), sampler=tinteg.SamplerConfig(kind="sobol", spp=4),
        integrator="path", max_depth=4)
    return scene, camera, cfg


GOLDEN_SETUPS = {
    "config2_cornell_path":
        lambda: entry.golden2_cornell_path(res=32, spp=4, device="cpu"),
    "config3_mesh_octree_textured":
        lambda: entry.golden3_mesh_octree_textured(res=32, spp=2,
                                                   device="cpu"),
    "config4_spectral": _golden4_spectral,
}


@pytest.mark.parametrize("name", sorted(GOLDEN_SETUPS))
def test_render_matches_golden(name):
    """The port's own Scene.build + render() against a checked-in golden at
    the golden test's tolerance."""
    scene, camera, cfg = GOLDEN_SETUPS[name]()
    film, sensor = tinteg.render(scene, camera, cfg, chunk=cfg.sampler.spp)
    img = film.resolve(sensor, to_srgb=False, clip=False).numpy()
    assert np.isfinite(img).all() and film.spp_done == cfg.sampler.spp
    golden = np.load(os.path.join(GOLDEN_DIR, name + ".npy"))
    np.testing.assert_allclose(img, golden,
                               atol=2e-3 * max(float(golden.max()), 1e-3))


def test_render_resume_and_chunks_agree():
    scene, camera, cfg = entry.golden2_cornell_path(res=16, spp=4,
                                                    device="cpu")
    a, _ = tinteg.render(scene, camera, cfg, chunk=4)
    b, _ = tinteg.render(scene, camera, cfg, passes=2)
    b, _ = tinteg.render(scene, camera, cfg, film=b)
    assert b.spp_done == 4
    np.testing.assert_allclose(b.rgb_sum.numpy(), a.rgb_sum.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_scene_build_matches_reference(cornell32):
    """Scene.build in the port vs the reference (LM fit may differ in the
    last bits, so coefficients within 2e-3 and emission within 1e-4)."""
    jscene, *_ = cornell32
    tscene, _, _ = entry.cornell_setup(res=32, spp=2, device="cpu")
    jm, tm = jscene.materials, tscene.materials
    np.testing.assert_array_equal(tm.kind.numpy(), np.asarray(jm.kind))
    np.testing.assert_allclose(tm.albedo_coeffs.numpy(),
                               np.asarray(jm.albedo_coeffs), atol=2e-3)
    for k in ("emission", "eta", "k"):
        ref = np.asarray(getattr(jm, k))
        np.testing.assert_allclose(getattr(tm, k).numpy(), ref, rtol=0,
                                   atol=1e-4 * max(ref.max(), 1.0))
    for k in ("position", "direction", "edge1", "edge2", "scale"):
        np.testing.assert_array_equal(getattr(tscene.lights, k).numpy(),
                                      np.asarray(getattr(jscene.lights, k)))
    ref = np.asarray(jscene.lights.spd)
    np.testing.assert_allclose(tscene.lights.spd.numpy(), ref,
                               atol=1e-4 * ref.max())
    assert tscene.wr == pytest.approx(jscene.wr, rel=1e-7)
    assert tscene.has_rough == jscene.has_rough


def _material_inputs(n=400, seed=4):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo = np.where((wo * nrm).sum(1, keepdims=True) < 0, -wo, wo)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    lam = jspec.sample_visible_wavelengths(
        jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))).lam
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    mid = rng.integers(0, 4, n)
    back = rng.uniform(0, 1, n) < 0.3
    return nrm, wo, wi, np.asarray(lam), u2, u1, mid, back


MATS = [{"kind": "diffuse", "albedo_rgb": (0.7, 0.2, 0.1)},
        {"kind": "conductor", "albedo_rgb": (1, 1, 1), "metal": "metal-Au"},
        {"kind": "dielectric", "albedo_rgb": (1, 1, 1), "glass": "glass-BK7"},
        {"kind": "rough_conductor", "albedo_rgb": (0.9, 0.8, 0.7),
         "metal": "metal-Cu", "roughness": 0.3}]


@pytest.mark.parametrize("fn", ["eval", "sample"])
def test_bsdf_all_kinds_match(fn):
    jt = jmat.MaterialTable.build(MATS)
    tt = tmat.MaterialTable.from_arrays(
        {k: np.asarray(getattr(jt, k)) for k in tmat.FIELDS})
    nrm, wo, wi, lam, u2, u1, mid, back = _material_inputs()

    def jfun(mid_, n_, wo_, wi_, lam_, u2_, u1_, back_):
        view = jmat.MaterialView.create(jt, mid_)
        ek = jmat.material_spectra(view, lam_)[1:]
        if fn == "eval":
            return jmat.bsdf_eval(view, n_, wo_, wi_, lam_, eta_k=ek)
        return jmat.bsdf_sample(view, n_, wo_, u2_, u1_, lam_, eta_k=ek,
                                backface=back_)

    ref = jax.jit(jfun)(mid, nrm, wo, wi, lam, u2, u1, back)
    view = tmat.MaterialView.create(tt, T(mid))
    ek = tmat.material_spectra(view, T(lam))[1:]
    if fn == "eval":
        got = tmat.bsdf_eval(view, T(nrm), T(wo), T(wi), T(lam), ek)
    else:
        got = tmat.bsdf_sample(view, T(nrm), T(wo), T(u2), T(u1), T(lam),
                               ek, T(back))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        if r.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-5, atol=2e-5)


def test_lights_all_kinds_match():
    lights = [{"kind": "point", "position": (0.3, 1.5, -0.2), "scale": 5.0},
              {"kind": "distant", "direction": (-0.3, -1.0, 0.4),
               "rgb": (1.0, 0.9, 0.8)},
              {"kind": "quad", "corner": (-0.5, 0.99, -0.5),
               "edge1": (1.0, 0, 0), "edge2": (0, 0, 1.0),
               "spd_named": "stdillum-D65", "scale": 3.0},
              {"kind": "ambient", "scale": 0.5}]
    jt = jlgt.LightTable.build(lights)
    tt = tlgt.LightTable.build(lights)
    for k in tlgt.FIELDS:
        np.testing.assert_allclose(getattr(tt, k).numpy(),
                                   np.asarray(getattr(jt, k)), rtol=1e-5,
                                   atol=1e-6)
    tt = tlgt.LightTable.from_arrays(
        {k: np.asarray(getattr(jt, k)) for k in tlgt.FIELDS})
    nrm, wo, _, lam, u2, u1, _, _ = _material_inputs(seed=6)
    rng = np.random.default_rng(7)
    p = rng.uniform(-0.9, 0.9, (nrm.shape[0], 3)).astype(np.float32)
    ref = jax.jit(lambda *a: jlgt.sample_light(jt, *a, 10.0))(
        p, nrm, lam, u1, u2)
    spd_vals = tspec.sample_dense_multi(tt.spd.T.contiguous(), T(lam))
    got = tlgt.sample_light(tt, T(p), T(nrm), T(u1), T(u2), spd_vals, 10.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)
    t_hit = rng.uniform(0.1, 3.0, nrm.shape[0]).astype(np.float32)
    ref = jax.jit(lambda a, b, c: jlgt.pdf_light_direction(jt, a, b, c))(
        p, wo, t_hit)
    np.testing.assert_allclose(
        tlgt.pdf_light_direction(tt, T(p), T(wo), T(t_hit)).numpy(),
        np.asarray(ref), rtol=2e-5, atol=1e-6)
    ref_env, _ = jlgt.env_radiance(jt, jnp.asarray(lam))
    np.testing.assert_allclose(tlgt.env_radiance(tt, spd_vals).numpy(),
                               np.asarray(ref_env), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlgt.pdf_ambient_direction(tt, T(nrm), T(wo)).numpy(),
        np.asarray(jlgt.pdf_ambient_direction(jt, jnp.asarray(nrm),
                                              jnp.asarray(wo))),
        rtol=1e-6, atol=1e-7)


def test_unported_options_raise():
    scene, camera, cfg = entry.cornell_setup(8, 1, device="cpu")
    with pytest.raises(NotImplementedError):
        tinteg.SamplerConfig(kind="sobol_global")
    for change in ({"integrator": "simple"}, {"integrator": "walk"},
                   {"filter_name": "lanczos"}):
        with pytest.raises(NotImplementedError):
            dataclasses.replace(cfg, **change)


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import computational_ray_tracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('computational_ray_tracer_tpu.')"
        " or m == 'computational_ray_tracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
