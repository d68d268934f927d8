"""The port's cylinders and disks, bounds helpers, the four camera kinds,
the Lanczos filter and the shape scenes of ``entry.shapes_setup`` against
the JAX package on the same seeded inputs."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.models import scene as jscene_mod
from computational_ray_tracer_tpu.ops import camera as jcam
from computational_ray_tracer_tpu.ops import filters as jflt
from computational_ray_tracer_tpu.ops import numeric as jnum
from computational_ray_tracer_tpu.ops import shapes as jshp
from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.models import scene as tscene_mod
from computational_ray_tracer_tpu_torch.ops import camera as tcam
from computational_ray_tracer_tpu_torch.ops import filters as tflt
from computational_ray_tracer_tpu_torch.ops import numeric as tnum
from computational_ray_tracer_tpu_torch.ops import shapes as tshp

T = torch.as_tensor

CYLINDERS = [
    {"radius": 0.7, "z_min": -1.0, "z_max": 1.0,
     "transform": tshp.make_transform(rotate_deg=(90, 0, 0))},
    {"radius": 0.4, "z_min": -0.5, "z_max": 0.8, "phi_max": 4.0,
     "transform": tshp.make_transform((0.5, 0.2, 0.1), (10, 20, 30), 1.3)}]
DISKS = [
    {"radius": 1.2, "inner_radius": 0.3,
     "transform": tshp.make_transform(rotate_deg=(25, 0, 0))},
    {"radius": 0.6, "height": 0.3, "phi_max": 3.0,
     "transform": tshp.make_transform((0.2, -0.3, 0.4), (0, 40, 0))}]
SHAPES = {
    "cylinder": (CYLINDERS, "CylinderTable", "cylinder_intersect_t",
                 "cylinder_surface"),
    "disk": (DISKS, "DiskTable", "disk_intersect_t", "disk_surface"),
}


def _rays(n=3000, seed=0):
    """Seeded rays from a box around the shapes toward points near the
    origin; a tenth with a finite t_max."""
    gen = np.random.default_rng(seed)
    o = gen.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = gen.uniform(-1, 1, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(n, np.inf, np.float32)
    t_max[: n // 10] = 2.0
    return o, d, t_max


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_shape_tables_match_jax(kind):
    """intersect_t (hit or miss exactly, t within rtol 1e-5) and the
    surface record of each ray's winner (the closest shape, ids exactly;
    floats within atol 1e-4 as tests/test_shapes.py)."""
    items, table, intersect_t, surface = SHAPES[kind]
    jtab = getattr(jshp, table).build(items)
    ttab = getattr(tshp, table).build(items)
    for f in ("o2w", "w2o", "radius", "phi_max"):
        np.testing.assert_array_equal(getattr(ttab, f).numpy(),
                                      np.asarray(getattr(jtab, f)))
    o, d, t_max = _rays()
    tj = np.asarray(getattr(jshp, intersect_t)(jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(t_max), jtab))
    tt = getattr(tshp, intersect_t)(T(o), T(d), T(t_max), ttab).numpy()
    hit = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    assert 0.1 < hit.any(-1).mean() < 0.9
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5)
    idx = np.argmin(tj, -1)
    np.testing.assert_array_equal(np.argmin(tt, -1), idx)
    t = np.where(hit.any(-1), tj.min(-1), 1.0).astype(np.float32)
    sj = getattr(jshp, surface)(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t), jnp.asarray(idx), jtab)
    st = getattr(tshp, surface)(T(o), T(d), T(t), T(idx), ttab)
    m = hit.any(-1)
    np.testing.assert_array_equal(st.backface.numpy()[m],
                                  np.asarray(sj.backface)[m])
    for f in ("p", "n", "uv", "dpdu", "dpdv", "wo"):
        np.testing.assert_allclose(getattr(st, f).numpy()[m],
                                   np.asarray(getattr(sj, f))[m], rtol=0,
                                   atol=1e-4)


def test_cylinder_and_disk_reference_cases():
    """tests/test_shapes.py's cylinder hit and normal, z clip and annulus
    cases on the port."""
    tab = tshp.CylinderTable.build([{"radius": 1.0, "z_min": -1,
                                     "z_max": 1}])
    one = lambda o, d: (T([o], dtype=torch.float32),
                        T([d], dtype=torch.float32), T([math.inf]))
    o, d, tm = one([-4, 0, 0.3], [1, 0, 0])
    t = tshp.cylinder_intersect_t(o, d, tm, tab)
    assert float(t[0, 0]) == pytest.approx(3.0, abs=1e-4)
    si = tshp.cylinder_surface(o, d, t[:, 0],
                               torch.zeros(1, dtype=torch.int64), tab)
    np.testing.assert_allclose(si.n[0].numpy(), [-1, 0, 0], atol=1e-4)
    o, d, tm = one([-4, 0, 1.5], [1, 0, 0])
    assert not math.isfinite(float(tshp.cylinder_intersect_t(o, d, tm,
                                                             tab)[0, 0]))
    tab = tshp.DiskTable.build([{"radius": 1.0, "inner_radius": 0.25,
                                 "height": 0.0}])
    t = tshp.disk_intersect_t(T([[0.5, 0, -3], [0.1, 0, -3], [1.5, 0, -3]],
                                dtype=torch.float32),
                              T([[0, 0, 1]] * 3, dtype=torch.float32),
                              T([math.inf] * 3), tab)
    assert float(t[0, 0]) == pytest.approx(3.0, abs=1e-4)
    assert not np.isfinite(t[1:, 0].numpy()).any()


def test_bounds_helpers_match_jax():
    """transform_ray, transform_bounds, bounds_union and the slab test
    against the reference's on seeded boxes and rays."""
    m, _ = tshp.make_transform((1, 2, 3), (30, 45, 10), 1.5)
    lo, hi = np.float32([-1, -2, -0.5]), np.float32([1, 0.5, 2])
    jlo, jhi = jshp.transform_bounds(jnp.asarray(m), jnp.asarray(lo),
                                     jnp.asarray(hi))
    tlo, thi = tshp.transform_bounds(T(m), T(lo), T(hi))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), atol=1e-6)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), atol=1e-6)
    u = tshp.bounds_union(tlo, thi, T(lo), T(hi))
    ju = jshp.bounds_union(jlo, jhi, jnp.asarray(lo), jnp.asarray(hi))
    for a, b in zip(u, ju):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    o, d, t_max = _rays(2000, seed=3)
    d[:50, 0] = 0.0                      # rays parallel to a slab
    with np.errstate(divide="ignore"):
        inv_d = (1.0 / d).astype(np.float32)
    got = tshp.bounds_intersect_p(T(o), T(inv_d), T(t_max), T(lo), T(hi))
    ref = jshp.bounds_intersect_p(jnp.asarray(o), jnp.asarray(inv_d),
                                  jnp.asarray(t_max), jnp.asarray(lo),
                                  jnp.asarray(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.numpy().mean() < 0.95
    ro, rd = tshp.transform_ray(T(m), T(o), T(d))
    jo, jd = jshp.transform_ray(jnp.asarray(m), jnp.asarray(o),
                                jnp.asarray(d))
    np.testing.assert_allclose(ro.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jd), atol=1e-5)


CAMERAS = {
    "perspective": ("PerspectiveCamera", {"fov_y": 60.0}),
    "perspective_lens": ("PerspectiveCamera", {"fov_y": 45.0,
                                               "lens_radius": 0.2,
                                               "focal_distance": 3.0}),
    "orthographic": ("OrthographicCamera", {"window": (4.0, 3.0)}),
    "pinhole": ("PinholeCamera", {"hole_radius": 0.0}),
    "pinhole_hole": ("PinholeCamera", {"hole_radius": 0.01}),
    "thinlens": ("ThinLensCamera", {"aperture_radius": 0.05,
                                    "focus_distance": 2.0}),
}
PLACEMENTS = {"yaw_pitch": {"yaw": 123.0, "pitch": -20.0},
              "level": {},
              "look_at": {"look_at": (0.3, -0.2, 1.0)}}


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_cameras_match_jax(kind, placement):
    """generate_rays of each camera kind, placed by yaw/pitch or look-at,
    against the reference's (atol 1e-5 as tests/test_camera_film.py); the
    focal length and image distance of the thin lens."""
    name, kw = CAMERAS[kind]
    kw = dict(kw, **PLACEMENTS[placement])
    jc = getattr(jcam, name).create((1, 2, -3), (48, 32), **kw)
    tc = getattr(tcam, name).create((1, 2, -3), (48, 32), **kw)
    np.testing.assert_allclose(np.asarray(tc.basis), np.asarray(jc.basis),
                               rtol=0, atol=1e-15)
    gen = np.random.default_rng(4)
    px = gen.uniform(0, 1, (500, 2)).astype(np.float32) * [48, 32]
    px = px.astype(np.float32)
    u = gen.uniform(0, 1, (500, 2)).astype(np.float32)
    jo, jd = jc.generate_rays(jnp.asarray(px), jnp.asarray(u))
    to, td = tc.generate_rays(T(px), T(u))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    if name == "ThinLensCamera":
        assert tc.focal_length == jc.focal_length
        assert tc.image_distance == jc.image_distance


@pytest.mark.parametrize("radius", [(0.5, 0.5), (4.0, 4.0), (1.5, 2.0)])
def test_lanczos_filter_matches_jax(radius):
    """The Lanczos filter's sample (offset and sign-carrying weight),
    evaluate and integral against the reference's; sinc and windowed_sinc
    within one float32 rounding."""
    jf, tf = jflt.lanczos_sinc_filter(radius), tflt.lanczos_sinc_filter(radius)
    gen = np.random.default_rng(6)
    u = gen.uniform(0, 1, (4000, 2)).astype(np.float32)
    u[:4] = [[0, 0], [1, 1], [0.5, 0.5], [0.999999, 1e-7]]
    jp, jw = jf.sample(jnp.asarray(u))
    tp, tw = tf.sample(T(u))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    assert (tw.numpy() < 0).any() == (max(radius) > 1.0)
    p = gen.uniform(-5, 5, (4000, 2)).astype(np.float32)
    np.testing.assert_allclose(tf.evaluate(T(p)).numpy(),
                               np.asarray(jf.evaluate(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-7)
    assert tf.integral == pytest.approx(jf.integral, rel=1e-12)
    x = gen.uniform(-6, 6, 1000).astype(np.float32)
    x[:3] = [0.0, 1e-6, -3.0]
    np.testing.assert_allclose(tnum.sinc(T(x)).numpy(),
                               np.asarray(jnum.sinc(x)), rtol=0, atol=2e-7)
    np.testing.assert_allclose(tnum.windowed_sinc(T(x), 4.0, 3.0).numpy(),
                               np.asarray(jnum.windowed_sinc(x, 4.0, 3.0)),
                               rtol=0, atol=2e-7)


def _shape_scenes(kind):
    """(JAX scene, the port's Scene.build, the port's scene converted from
    the JAX one) of entry.shape_items(kind)."""
    from test_torch_render import export_scene
    jscene = jscene_mod.Scene.build(entry.SHAPE_MATERIALS, entry.SHAPE_LIGHTS,
                                    **entry.shape_items(kind))
    tbuilt, _, _ = entry.shapes_setup(kind, "perspective", 8, device="cpu")
    return jscene, tbuilt, convert.scene_from_numpy(export_scene(jscene),
                                                    "cpu")


def test_scene_with_every_shape_kind():
    """Scene.build with spheres, cylinders and disks: the port's tables and
    world radius equal the reference's, and scene_intersect gives the same
    type, shape and material ids on seeded rays."""
    mats = entry.SHAPE_MATERIALS + [{"kind": "diffuse",
                                     "albedo_rgb": (0.2, 0.5, 0.3)}]
    args = dict(spheres=[{"radius": 0.5, "material": 1,
                          "transform": tshp.make_transform((1.2, 0, 0))}],
                cylinders=[dict(c, material=i % 2)
                           for i, c in enumerate(CYLINDERS)],
                disks=[dict(c, material=(i + 1) % 2)
                       for i, c in enumerate(DISKS)])
    jscene = jscene_mod.Scene.build(mats, entry.SHAPE_LIGHTS, **args)
    tscene = tscene_mod.Scene.build(mats, entry.SHAPE_LIGHTS, device="cpu",
                                    **args)
    for prefix, _, fields, mat_key in convert.SHAPE_TABLES:
        for f in fields:
            np.testing.assert_array_equal(
                getattr(getattr(tscene, prefix), f).numpy(),
                np.asarray(getattr(getattr(jscene, prefix), f)))
        np.testing.assert_array_equal(getattr(tscene, mat_key).numpy(),
                                      np.asarray(getattr(jscene, mat_key)))
    assert tscene.wr == pytest.approx(jscene.wr, rel=1e-7)
    o, d, t_max = _rays(3000, seed=7)
    hj = jscene_mod.scene_intersect_t(jscene, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(t_max))
    ht = tscene_mod.scene_intersect_t(tscene, T(o), T(d), T(t_max))
    np.testing.assert_array_equal(ht[1].numpy(), np.asarray(hj[1]))
    np.testing.assert_array_equal(ht[2].numpy(), np.asarray(hj[2]))
    assert len(set(ht[1].tolist())) == 4           # miss + three kinds
    sj, mj, _ = jscene_mod.scene_intersect(jscene, jnp.asarray(o),
                                           jnp.asarray(d), jnp.asarray(t_max))
    st, mt, _ = tscene_mod.scene_intersect(tscene, T(o), T(d), T(t_max))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(sj.valid))
    v = st.valid.numpy()
    np.testing.assert_allclose(st.n.numpy()[v], np.asarray(sj.n)[v],
                               atol=1e-4)
    occ_j = jscene_mod.scene_anyhit(jscene, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t_max))
    occ_t = tscene_mod.scene_anyhit(tscene, T(o), T(d), T(t_max))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


@pytest.mark.parametrize("camera", ["orthographic", "pinhole", "thinlens"])
@pytest.mark.parametrize("kind", ["sphere", "cylinder", "disk"])
def test_shapes_setup_pass_matches_jax(kind, camera):
    """One direct pass of each shapes_setup scene under each new camera
    against the JAX render_pass on the same scene, atol 2e-3*max; the
    port's own Scene.build gives the converted scene's tables."""
    jscene, tbuilt, tscene = _shape_scenes(kind)
    for prefix, _, fields, _ in convert.SHAPE_TABLES:
        if getattr(tscene, prefix) is not None:
            for f in fields:
                np.testing.assert_array_equal(
                    getattr(getattr(tbuilt, prefix), f).numpy(),
                    getattr(getattr(tscene, prefix), f).numpy())
    _, tcamera, tcfg = entry.shapes_setup(kind, camera, 32, device="cpu")
    name, kw = entry.SHAPE_CAMERAS[camera]
    jcamera = getattr(jcam, name).create(entry.SHAPE_EYE, (32, 32),
                                         look_at=(0.0, 0.0, 0.0), **kw)
    jcfg = jinteg.RenderConfig(
        resolution=(32, 32), sampler=jinteg.SamplerConfig(kind="sobol", spp=4),
        integrator="direct", max_depth=1)
    rj, wj = jinteg.render_pass(jscene, jcamera, jcfg,
                                jinteg.make_filter(jcfg),
                                jinteg.make_sensor(jcfg), jnp.uint32(1))
    rt, wt = tinteg.render_pass(tscene, tcamera, tcfg,
                                tinteg.make_filter(tcfg),
                                tinteg.make_sensor(tcfg), 1)
    rj = np.asarray(rj)
    assert rj.max() > 0 and (rj.sum(-1) > 0).mean() > 0.1
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                               atol=2e-3 * float(rj.max()))
