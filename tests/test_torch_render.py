"""The port's slice end to end against the JAX reference: materials and
lights on the same inputs, one render_pass of the Cornell + sphere scene
carried across with convert.scene_from_numpy (also with the simple and walk
integrators, uniform hero wavelengths, the firefly clamp, a named sensor,
the sobol_global sampler, the Lanczos filter and a filter radius), the
sensors' calibration, the port's own Scene.build + render()
against the checked-in goldens, and the no-jax import rule."""

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
from chip_smoke import edge_pixels
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
    for prefix, _, fields, mat_key in convert.SHAPE_TABLES:
        table = getattr(scene, prefix)
        if table is not None:
            for k in fields:
                a[prefix + "." + k] = np.asarray(getattr(table, k))
            a[mat_key] = np.asarray(getattr(scene, mat_key))
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
    "config1_sphere_direct": lambda: entry.golden1_sphere_direct(device="cpu"),
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
        got = tmat.bsdf_eval(view, T(nrm), T(wo), T(wi), T(lam), eta_k=ek)
    else:
        got = tmat.bsdf_sample(view, T(nrm), T(wo), T(u2), T(u1), T(lam),
                               eta_k=ek, backface=T(back))
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
    got = tlgt.sample_light(tt, T(p), T(nrm), T(lam), T(u1), T(u2), 10.0,
                            spd_vals=spd_vals)
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
    np.testing.assert_allclose(tlgt.env_radiance(tt, T(lam),
                                                 spd_vals)[0].numpy(),
                               np.asarray(ref_env), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlgt.pdf_ambient_direction(tt, T(nrm), T(wo)).numpy(),
        np.asarray(jlgt.pdf_ambient_direction(jt, jnp.asarray(nrm),
                                              jnp.asarray(wo))),
        rtol=1e-6, atol=1e-7)


def test_unported_options_raise():
    """Every sampler kind and filter of the reference is ported; an unknown
    sampler kind or filter name raises."""
    scene, camera, cfg = entry.cornell_setup(8, 1, device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        tinteg.SamplerConfig(kind="halton")
    with pytest.raises(ValueError, match="filter"):
        dataclasses.replace(cfg, filter_name="mitchell")
    for kind in tinteg.SAMPLERS:
        tinteg.SamplerConfig(kind=kind)
    for name in ("box", "triangle", "gaussian", "lanczos"):
        dataclasses.replace(cfg, filter_name=name)


RENDER_OPTIONS = {
    "simple": {"integrator": "simple"},
    "walk": {"integrator": "walk"},
    "uniform_lambda": {"lambda_mode": "uniform"},
    "clamp": {"clamp": 0.05},
    "named_sensor": {"sensor_name": "canon_eos_5d"},
    "sobol_global": {"sampler": {"kind": "sobol_global", "spp": 2}},
    "lanczos": {"filter_name": "lanczos"},
    "filter_radius": {"filter_name": "triangle", "filter_radius": (1.0, 0.75)},
}


def _with_options(mod, cfg, change):
    """cfg with RENDER_OPTIONS ``change``; a ``sampler`` entry is a dict of
    SamplerConfig fields, built with ``mod``'s SamplerConfig (RenderConfig
    derives the sobol_global image geometry)."""
    change = dict(change)
    if "sampler" in change:
        change["sampler"] = mod.SamplerConfig(**change["sampler"])
    return dataclasses.replace(cfg, **change)


@pytest.mark.parametrize("name", sorted(RENDER_OPTIONS))
def test_render_options_match_jax(cornell32, name):
    """The simple and walk integrators, uniform hero wavelengths, the
    firefly clamp, a named sensor, the sobol_global sampler, the Lanczos
    filter and a filter radius: the port's render_pass against the JAX
    render_pass (eager) on the Cornell + sphere scene, atol 2e-3*max as
    the golden tests, on every pixel but those whose camera ray meets a
    triangle edge (chip_smoke.edge_pixels; none but sobol_global's 32
    diagonal pixels, whose equal in-pixel offsets send their rays onto
    the box's edges, where which wall is hit turns on the last bit of t:
    the reference's own hit there changes with its batch size)."""
    jscene, jcamera, jcfg, tscene = cornell32
    change = RENDER_OPTIONS[name]
    jcfg = _with_options(jinteg, jcfg, change)
    rj, wj = jinteg.render_pass(jscene, jcamera, jcfg,
                                jinteg.make_filter(jcfg),
                                jinteg.make_sensor(jcfg), jnp.uint32(0))
    _, tcamera, tcfg = entry.cornell_setup(res=32, spp=2, device="cpu")
    tcfg = _with_options(tinteg, tcfg, change)
    rt, wt = tinteg.render_pass(tscene, tcamera, tcfg,
                                tinteg.make_filter(tcfg),
                                tinteg.make_sensor(tcfg), 0)
    rj, wj = np.asarray(rj), np.asarray(wj)
    assert np.isfinite(rt.numpy()).all() and rj.max() > 0
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-5, atol=1e-6)
    edge = edge_pixels(tscene, tcamera, tcfg, 0).numpy()
    assert edge.sum() == (32 if name == "sobol_global" else 0)
    np.testing.assert_allclose(rt.numpy()[~edge], rj[~edge], rtol=0,
                               atol=2e-3 * max(float(rj.max()), 1e-3))


@pytest.mark.parametrize("name", [None, "canon_eos_5d", "sony_ilce_9"])
def test_sensor_matches_reference(name):
    """PixelSensor.create: the curves and the ColorChecker least-squares
    matrix (and, for the XYZ sensor, the Bradford white balance from an
    F1 sensor illuminant) against the reference's, and uniform hero
    wavelengths bit for bit."""
    from computational_ray_tracer_tpu.ops import sensor as jsen
    from computational_ray_tracer_tpu.ops import spectra_data as jdata
    illum = None if name else jdata.get_named_spectrum("stdillum-F1")
    ref = jsen.PixelSensor.create(name, sensor_illum=illum)
    got = tsen.PixelSensor.create(name, sensor_illum=illum)
    np.testing.assert_array_equal(got.curves, np.asarray(ref.curves))
    np.testing.assert_allclose(got.xyz_from_sensor_rgb,
                               ref.xyz_from_sensor_rgb, rtol=1e-6,
                               atol=1e-7)
    u = np.random.default_rng(3).uniform(0, 1, 1000).astype(np.float32)
    jw = jspec.sample_uniform_wavelengths(jnp.asarray(u))
    tw = tspec.sample_uniform_wavelengths(T(u))
    np.testing.assert_array_equal(tw.lam.numpy(), np.asarray(jw.lam))
    np.testing.assert_array_equal(tw.pdf.numpy(), np.asarray(jw.pdf))


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
