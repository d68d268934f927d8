"""The port's spectral, colour, sensor, filter, camera and film modules
against the JAX reference on the same numpy-seeded inputs.

Tolerances: gathers and lerps are the same float32 operations (exact);
transcendental functions (atanh, cosh, exp, erfinv's log) come from two
libraries and may differ by a few ulp, hence rtol 1e-6 (pdf) and atol 2e-4 nm
on wavelengths near 830 nm (a few ulp there); the LM colour fit takes its
Jacobian in closed form instead of by autodiff, so coefficients agree to
~1e-3 and the fitted reflectances to 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from computational_ray_tracer_tpu.ops import camera as jcam
from computational_ray_tracer_tpu.ops import color as jcolor
from computational_ray_tracer_tpu.ops import film as jfilm
from computational_ray_tracer_tpu.ops import filters as jflt
from computational_ray_tracer_tpu.ops import sensor as jsen
from computational_ray_tracer_tpu.ops import spectrum as jspec
from computational_ray_tracer_tpu.ops import spectra_data as jdata
from computational_ray_tracer_tpu_torch.ops import camera as tcam
from computational_ray_tracer_tpu_torch.ops import color as tcolor
from computational_ray_tracer_tpu_torch.ops import film as tfilm
from computational_ray_tracer_tpu_torch.ops import filters as tflt
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
from computational_ray_tracer_tpu_torch.ops import spectrum as tspec
from computational_ray_tracer_tpu_torch.ops import spectra_data as tdata

RNG = np.random.default_rng(1)
U = RNG.uniform(0, 1, 600).astype(np.float32)
U2 = RNG.uniform(0, 1, (600, 2)).astype(np.float32)
LAM = RNG.uniform(350, 840, (600, 8)).astype(np.float32)   # some outside
T = lambda a: torch.tensor(np.asarray(a))


def test_data_tables_identical():
    np.testing.assert_array_equal(tdata.DENSE_LAMBDA, jdata.DENSE_LAMBDA)
    for name in ("CIE_X", "CIE_Y", "CIE_Z", "ILLUM_D65", "ILLUM_E"):
        np.testing.assert_array_equal(getattr(tdata, name),
                                      getattr(jdata, name))
    for m in jdata.METAL_ETA:
        np.testing.assert_array_equal(tdata.METAL_ETA[m], jdata.METAL_ETA[m])
        np.testing.assert_array_equal(tdata.METAL_K[m], jdata.METAL_K[m])
    assert tdata.CIE_Y_INTEGRAL == jdata.CIE_Y_INTEGRAL


@pytest.mark.parametrize("u", [U, np.array([0.0, 0.5, 1.0 - 2 ** -24],
                                             np.float32)])
def test_sampled_wavelengths(u):
    a = jspec.sample_visible_wavelengths(jnp.asarray(u))
    b = tspec.sample_visible_wavelengths(T(u))
    np.testing.assert_allclose(b.lam.numpy(), np.asarray(a.lam), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(b.pdf.numpy(), np.asarray(a.pdf), rtol=1e-6)


@pytest.mark.parametrize("fn", ["multi", "rows", "one", "cie"])
def test_dense_interpolation_exact(fn):
    tab = RNG.uniform(0, 2, (471, 5)).astype(np.float32)
    if fn == "multi":
        ref = jspec.sample_dense_multi(jnp.asarray(tab), jnp.asarray(LAM))
        got = tspec.sample_dense_multi(T(tab), T(LAM))
    elif fn == "rows":
        rows = RNG.integers(-1, 7, LAM.shape[0])       # out of range clamps
        ref = jspec.sample_dense_rows(jnp.asarray(tab.T), jnp.asarray(rows),
                                      jnp.asarray(LAM))
        got = tspec.sample_dense_rows(T(tab.T.copy()), T(rows), T(LAM))
    elif fn == "one":
        ref = jspec.sample_dense(jnp.asarray(tab[:, 0]), jnp.asarray(LAM))
        got = tspec.sample_dense(T(tab[:, 0]), T(LAM))
    else:
        ref = jspec.cie_xyz_at(jnp.asarray(LAM))
        got = tspec.cie_xyz_at(T(LAM))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sigmoid_polynomial():
    coeffs = RNG.normal(0, 3, (600, 3)).astype(np.float32)
    ref = jcolor.sigmoid_polynomial(jnp.asarray(coeffs), jnp.asarray(LAM))
    got = tcolor.sigmoid_polynomial(T(coeffs), T(LAM))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


def test_rgb_fit_and_illuminant_spectrum():
    rgb = np.array([[0.73, 0.73, 0.73], [0.65, 0.05, 0.05],
                    [0.12, 0.45, 0.15], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                    [0.5, 0.425, 0.3]], np.float32)
    ref = np.asarray(jcolor.fit_rgb_to_spectrum(jnp.asarray(rgb)))
    got = tcolor.fit_rgb_to_spectrum(rgb).numpy()
    lam = np.broadcast_to(np.arange(360, 831, 5, dtype=np.float32),
                          (6, 95)).copy()
    np.testing.assert_allclose(
        tcolor.sigmoid_polynomial(T(got), T(lam)).numpy(),
        np.asarray(jcolor.sigmoid_polynomial(jnp.asarray(ref),
                                             jnp.asarray(lam))),
        rtol=0, atol=1e-4)
    dense = np.arange(360, 831, dtype=np.float32)
    e_ref = np.asarray(jcolor.RGBIlluminantSpectrum.from_rgb(
        jnp.asarray([1.0, 0.85, 0.6], jnp.float32))(jnp.asarray(dense)))
    e_got = tcolor.RGBIlluminantSpectrum.from_rgb([1.0, 0.85, 0.6])(
        T(dense)).numpy()
    np.testing.assert_allclose(e_got, e_ref, rtol=0, atol=1e-5 * e_ref.max())


def test_sensor_rgb_and_xyz():
    L = RNG.uniform(0, 3, (600, 8)).astype(np.float32)
    wl = jspec.sample_visible_wavelengths(jnp.asarray(U))
    twl = tspec.SampledWavelengths(T(wl.lam), T(wl.pdf))
    ref = jsen.PixelSensor.create(None).to_sensor_rgb(jnp.asarray(L), wl)
    got = tsen.PixelSensor.create().to_sensor_rgb(T(L), twl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        tspec.sampled_to_xyz(T(L), twl).numpy(),
        np.asarray(jspec.sampled_to_xyz(jnp.asarray(L), wl)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("radius", [(0.5, 0.5), (1.5, 1.0)])
def test_gaussian_filter(radius):
    a = jflt.gaussian_filter(radius)
    b = tflt.gaussian_filter(radius)
    pa, wa = a.sample(jnp.asarray(U2))
    pb, wb = b.sample(T(U2))
    np.testing.assert_allclose(pb.numpy(), np.asarray(pa), rtol=0, atol=1e-6)
    np.testing.assert_allclose(wb.numpy(), np.asarray(wa), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(b.evaluate(pb).numpy(),
                               np.asarray(a.evaluate(pa)), atol=1e-6)
    assert b.integral == pytest.approx(a.integral, rel=1e-12)


@pytest.mark.parametrize("lens", [False, True])
def test_perspective_camera(lens):
    kw = dict(lens_radius=0.1, focal_distance=2.5) if lens else {}
    a = jcam.PerspectiveCamera.create((0.3, 0.2, -2.8), (64, 48), fov_y=50.0,
                                      look_at=(0.1, -0.2, 0.4), **kw)
    b = tcam.PerspectiveCamera.create((0.3, 0.2, -2.8), (64, 48), fov_y=50.0,
                                      look_at=(0.1, -0.2, 0.4), **kw)
    px = RNG.uniform(0, 48, (600, 2)).astype(np.float32)
    oa, da = a.generate_rays(jnp.asarray(px), jnp.asarray(U2))
    ob, db = b.generate_rays(T(px), T(U2))
    np.testing.assert_allclose(ob.numpy(), np.asarray(oa), atol=1e-6)
    np.testing.assert_allclose(db.numpy(), np.asarray(da), atol=1e-6)


def test_film_accumulate_and_resolve():
    rgb = RNG.uniform(0, 1, (6, 5, 3)).astype(np.float32)
    w = RNG.uniform(0.5, 1, (6, 5)).astype(np.float32)
    fa = jfilm.Film.create((5, 6)).add_aligned(jnp.asarray(rgb),
                                                jnp.asarray(w))
    fb = tfilm.Film.create((5, 6)).add_aligned(T(rgb), T(w))
    sa, sb = jsen.PixelSensor.create(None), tsen.PixelSensor.create()
    for kw in ({}, {"to_srgb": False, "clip": False}):
        np.testing.assert_allclose(fb.resolve(sb, **kw).numpy(),
                                   np.asarray(fa.resolve(sa, **kw)),
                                   rtol=1e-6, atol=1e-6)
    assert fb.spp_done == int(fa.spp_done) == 1
