"""The rest of the port's numeric, spectral-data, spectrum, colour and
sensor modules against the JAX reference on the same numpy-seeded inputs.

Tolerances: ``two_prod``/``two_sum``/``compensated_sum`` bitwise;
integers and indices exactly; NumPy functions (the spectral data models)
exactly, being the same NumPy code; element-wise float32 functions
(spectra, pdfs, colour conversions) rtol 1e-5 / atol 1e-6 (transcendentals
from two libraries, sums in another order); ``linear_least_squares`` 1e-5.
Whatever goes through the RGB -> sigmoid fit (the synthetic ColorChecker
swatches, ``RGBUnboundedSpectrum.from_rgb``,
``RGBToSpectrumTable.generate``) keeps that fit's documented
tolerance, 1e-4 on the reflectance (``tests/test_torch_spectral.py``: the
port takes the LM Jacobian in closed form), while the spectrum classes are
held at 1e-5 on equal coefficients.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computational_ray_tracer_tpu.ops import color as jcolor
from computational_ray_tracer_tpu.ops import numeric as jnum
from computational_ray_tracer_tpu.ops import sensor as jsen
from computational_ray_tracer_tpu.ops import shapes as jshapes
from computational_ray_tracer_tpu.ops import spectra_data as jdata
from computational_ray_tracer_tpu.ops import spectrum as jspec
from computational_ray_tracer_tpu_torch.ops import color as tcolor
from computational_ray_tracer_tpu_torch.ops import numeric as tnum
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
from computational_ray_tracer_tpu_torch.ops import spectra_data as tdata
from computational_ray_tracer_tpu_torch.ops import spectrum as tspec

RNG = np.random.default_rng(9)
J = jnp.asarray
T = lambda a: torch.tensor(np.asarray(a))
RTOL, ATOL = 1e-5, 1e-6
FIT_ATOL = 1e-4


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def bitwise(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def spread_f32(n):
    """float32 values over many binades, both signs."""
    m = RNG.uniform(1, 2, n) * 2.0 ** RNG.integers(-30, 30, n)
    return (m * RNG.choice([-1, 1], n)).astype(np.float32)


# ---------------------------------------------------------------------------
# numeric
# ---------------------------------------------------------------------------

def test_two_prod_is_exact_and_matches_shapes_split():
    a, b = spread_f32(4000), spread_f32(4000)
    prod, err = tnum.two_prod(T(a), T(b))
    ab = J(a) * J(b)
    bitwise(prod, ab)
    bitwise(err, jshapes._two_prod_err(J(a), J(b), ab))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(
        prod.numpy().astype(np.float64) + err.numpy().astype(np.float64),
        exact)
    # the reference's numeric.two_prod (split 0x10001) agrees on the product
    bitwise(prod, jnum.two_prod(J(a), J(b))[0])


def test_two_sum_and_compensated_sum_bitwise():
    a, b = spread_f32(4000), spread_f32(4000)
    for got, want in zip(tnum.two_sum(T(a), T(b)), jnum.two_sum(J(a), J(b))):
        bitwise(got, want)
    vals = (RNG.normal(0, 1, (37, 64)) * 10.0 ** RNG.integers(
        -6, 6, (37, 64))).astype(np.float32)
    for axis in (0, -1):
        bitwise(tnum.compensated_sum(T(vals), axis),
                jnum.compensated_sum(J(vals), axis))


def test_polynomial_interval_gaussian():
    t = RNG.uniform(-2, 2, 500).astype(np.float32)
    coeffs = (0.5, -1.25, 0.75, 2.0, -0.125)
    close(tnum.evaluate_polynomial(T(t), *coeffs),
          jnum.evaluate_polynomial(J(t), *coeffs))
    table = np.sort(RNG.uniform(0, 10, 40)).astype(np.float32)
    x = np.concatenate([RNG.uniform(-1, 11, 300), table[:5]]).astype(
        np.float32)
    np.testing.assert_array_equal(tnum.find_interval(T(table), T(x)).numpy(),
                                  np.asarray(jnum.find_interval(J(table),
                                                                J(x))))
    close(tnum.gaussian(T(t), 0.3, 0.7), jnum.gaussian(J(t), 0.3, 0.7))
    x0 = RNG.uniform(-3, 0, 200).astype(np.float32)
    x1 = x0 + RNG.uniform(0, 3, 200).astype(np.float32)
    close(tnum.gaussian_integral(T(x0), T(x1), 0.2, 1.3),
          jnum.gaussian_integral(J(x0), J(x1), 0.2, 1.3))
    close(tnum.sinc(T(t)), jnum.sinc(J(t)))
    close(tnum.windowed_sinc(T(t), 1.5, 3.0), jnum.windowed_sinc(J(t), 1.5,
                                                                 3.0))
    assert tnum.fp_gamma(3) == pytest.approx(float(jnum.fp_gamma(3)))


def test_linear_least_squares_and_select_rows():
    A = RNG.normal(0, 1, (24, 3)).astype(np.float32)
    B = RNG.normal(0, 1, (24, 2)).astype(np.float32)
    close(tnum.linear_least_squares(A, B), jnum.linear_least_squares(A, B),
          rtol=1e-5, atol=1e-5)
    tab = RNG.normal(0, 1, (6, 4)).astype(np.float32)
    idx = np.array([[0, 5, -3], [7, 2, 6]], np.int32)
    np.testing.assert_array_equal(
        tnum.select_rows(T(tab), T(idx).long()).numpy(),
        np.asarray(jnum.select_rows(J(tab), J(idx))))


# ---------------------------------------------------------------------------
# spectra_data
# ---------------------------------------------------------------------------

def test_spectral_data_models_equal():
    lam = RNG.uniform(300, 900, 257)
    for f in ("cie_x_fit", "cie_y_fit", "cie_z_fit"):
        np.testing.assert_array_equal(getattr(tdata, f)(lam),
                                      getattr(jdata, f)(lam))
    for temp in (1500.0, 2856.0, 5000.0, 6504.0, 9300.0):
        np.testing.assert_array_equal(tdata.blackbody(lam, temp),
                                      jdata.blackbody(lam, temp))
        np.testing.assert_array_equal(tdata.blackbody_normalized(lam, temp),
                                      jdata.blackbody_normalized(lam, temp))
    for temp in (2500.0, 4000.0, 5003.0, 6504.0, 7000.0, 7504.0, 12000.0):
        np.testing.assert_array_equal(tdata.d_illuminant(temp),
                                      jdata.d_illuminant(temp))
    np.testing.assert_array_equal(tdata._daylight(5500.0),
                                  jdata._daylight(5500.0))
    np.testing.assert_array_equal(tdata._fluorescent(4200.0, 0.6, 0.8),
                                  jdata._fluorescent(4200.0, 0.6, 0.8))
    assert tdata._SELLMEIER == jdata._SELLMEIER
    for coeffs in tdata._SELLMEIER.values():
        np.testing.assert_array_equal(tdata.sellmeier_ior(lam, coeffs),
                                      jdata.sellmeier_ior(lam, coeffs))


def test_spectral_data_tables_equal():
    for name in ("ILLUM_D75", "CIE_S_LAMBDA", "CIE_S0", "CIE_S1", "CIE_S2"):
        np.testing.assert_array_equal(getattr(tdata, name),
                                      getattr(jdata, name))
    assert tdata.ILLUM_F.keys() == jdata.ILLUM_F.keys()
    assert sorted(tdata.NAMED_SPECTRA) == sorted(jdata.NAMED_SPECTRA)
    for name, v in jdata.NAMED_SPECTRA.items():
        np.testing.assert_array_equal(tdata.get_named_spectrum(name), v)


# ---------------------------------------------------------------------------
# spectrum
# ---------------------------------------------------------------------------

LAM = RNG.uniform(350, 840, (300, 8)).astype(np.float32)
S = RNG.uniform(0, 3, (300, 8)).astype(np.float32)


def test_sampled_spectrum_helpers():
    close(tspec.average(T(S)), jspec.average(J(S)))
    close(tspec.spectrum_clamp(T(S), 0.5, 2.0),
          jspec.spectrum_clamp(J(S), 0.5, 2.0))
    close(tspec.spectrum_clamp(T(S - 1)), jspec.spectrum_clamp(J(S - 1)))
    b = RNG.uniform(0, 3, (300, 8)).astype(np.float32)
    t1 = RNG.uniform(0, 1, 300).astype(np.float32)
    close(tspec.spectrum_lerp(T(t1), T(S), T(b)),
          jspec.spectrum_lerp(J(t1), J(S), J(b)))
    t2 = RNG.uniform(0, 1, (300, 8)).astype(np.float32)
    close(tspec.spectrum_lerp(T(t2), T(S), T(b)),
          jspec.spectrum_lerp(J(t2), J(S), J(b)))
    u = RNG.uniform(0, 1, 500).astype(np.float32)
    close(tspec.sample_visible_wavelength(T(u)),
          jspec.sample_visible_wavelength(J(u)))
    pdf = S.copy()
    pdf[::3, 1:] = 0.0
    a = jspec.SampledWavelengths(J(LAM), J(pdf)).terminate_secondary()
    b = tspec.SampledWavelengths(T(LAM), T(pdf)).terminate_secondary()
    close(b.pdf, a.pdf)


def test_spectrum_classes():
    lam = T(LAM)
    close(tspec.ConstantSpectrum(0.6)(lam), jspec.ConstantSpectrum(0.6)(
        J(LAM)))
    for temp in (2856.0, 5000.0, 6504.0):
        close(tspec.BlackbodySpectrum(temp)(lam),
              jspec.BlackbodySpectrum(temp)(J(LAM)))
    pts = [400.0, 0.1, 550.0, 0.9, 550.0, 0.4, 700.0, 0.3]
    for normalize in (False, True):
        a = jspec.PiecewiseLinearSpectrum.from_interleaved(pts, normalize)
        b = tspec.PiecewiseLinearSpectrum.from_interleaved(pts, normalize)
        close(b(lam), a(J(LAM)))
        close(b.max_value(), a.max_value())
    d65 = tdata.ILLUM_D65
    dense_a = jspec.DenselySampledSpectrum.from_spectrum(
        jspec.BlackbodySpectrum(4000.0))
    dense_b = tspec.DenselySampledSpectrum.from_spectrum(
        tspec.BlackbodySpectrum(4000.0))
    close(dense_b.values, dense_a.values)
    close(dense_b.max_value(), dense_a.max_value())
    for f, g in ((tspec.BlackbodySpectrum(3000.0),
                  jspec.BlackbodySpectrum(3000.0)),
                 (tspec.DenselySampledSpectrum(T(d65)),
                  jspec.DenselySampledSpectrum(J(d65))),
                 (tspec.ConstantSpectrum(0.25), jspec.ConstantSpectrum(0.25))):
        close(tspec.spectrum_to_xyz(f, "cpu"), jspec.spectrum_to_xyz(g))
        close(tspec.spectrum_to_photometric(f, "cpu"),
              jspec.spectrum_to_photometric(g))
        close(tspec.inner_product(f, f, "cpu"),
              jspec.inner_product(g, g))


def test_sampled_y_and_dense_rows_multi():
    pdf = RNG.uniform(0.001, 0.01, (300, 8)).astype(np.float32)
    pdf[::7, 3] = 0.0
    close(tspec.sampled_y(T(S), tspec.SampledWavelengths(T(LAM), T(pdf))),
          jspec.sampled_y(J(S), jspec.SampledWavelengths(J(LAM), J(pdf))))
    tabs = [RNG.uniform(0, 2, (5, 471)).astype(np.float32) for _ in range(3)]
    rows = RNG.integers(-2, 8, 300).astype(np.int32)
    got = tspec.sample_dense_rows_multi([T(t) for t in tabs], T(rows).long(),
                                        T(LAM))
    want = jspec.sample_dense_rows_multi([J(t) for t in tabs], J(rows),
                                         J(LAM))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

def test_chromaticity():
    xy = RNG.uniform(0.05, 0.7, (200, 2)).astype(np.float32)
    xy[::9, 1] = 0.0
    for Y in (1.0, 0.35):
        close(tcolor.xyY_to_xyz(T(xy), Y), jcolor.xyY_to_xyz(J(xy), Y))
    xyz = RNG.uniform(0.01, 1.0, (200, 3)).astype(np.float32)
    close(tcolor.xyz_chromaticity(T(xyz)), jcolor.xyz_chromaticity(J(xyz)))
    c = RNG.uniform(0, 1, 500).astype(np.float32)
    close(tcolor.srgb_to_linear(T(c)), jcolor.srgb_to_linear(J(c)))
    close(tcolor.linear_to_srgb(T(c)), jcolor.linear_to_srgb(J(c)))


def test_color_spaces_and_conversions():
    assert tcolor.COLOR_SPACES.keys() == jcolor.COLOR_SPACES.keys()
    rgb = RNG.uniform(-0.2, 1.2, (100, 3)).astype(np.float32)
    for name, b in tcolor.COLOR_SPACES.items():
        a = jcolor.COLOR_SPACES[name]
        np.testing.assert_array_equal(b.xyz_from_rgb, a.xyz_from_rgb)
        np.testing.assert_array_equal(b.rgb_from_xyz, a.rgb_from_xyz)
        np.testing.assert_array_equal(b.illuminant, a.illuminant)
        assert b.w == a.w
        close(b.to_xyz(T(rgb)), a.to_xyz(J(rgb)))
        close(b.to_rgb(T(rgb)), a.to_rgb(J(rgb)))
        for dst in tcolor.COLOR_SPACES:
            close(tcolor.convert_rgb_colorspace(
                T(rgb), b, tcolor.COLOR_SPACES[dst]),
                jcolor.convert_rgb_colorspace(J(rgb), a,
                                              jcolor.COLOR_SPACES[dst]))
    for src, dst in (((0.3457, 0.3585), (0.3127, 0.3290)),
                     ((0.44757, 0.40745), (0.32168, 0.33767))):
        close(tcolor.white_balance_matrix(src, dst),
              jcolor.white_balance_matrix(src, dst))


def test_rgb_unbounded_spectrum():
    coeffs = RNG.normal(0, 2, (40, 3)).astype(np.float32)
    scale = RNG.uniform(0.1, 6, 40).astype(np.float32)
    lam = RNG.uniform(360, 830, (40, 8)).astype(np.float32)
    close(tcolor.RGBUnboundedSpectrum(T(coeffs), T(scale))(T(lam)),
          jcolor.RGBUnboundedSpectrum(J(coeffs), J(scale))(J(lam)))
    rgb = np.array([[2.0, 0.5, 0.25], [0.1, 3.0, 1.5], [0.3, 0.3, 0.3]],
                   np.float32)
    a = jcolor.RGBUnboundedSpectrum.from_rgb(J(rgb))
    b = tcolor.RGBUnboundedSpectrum.from_rgb(rgb)
    close(b.scale, a.scale)
    dense = np.broadcast_to(np.arange(360, 831, 5, dtype=np.float32),
                            (3, 95)).copy()
    close(b(T(dense)) / b.scale[:, None], a(J(dense)) / a.scale[:, None],
          rtol=0, atol=FIT_ATOL)


def test_rgb_to_spectrum_table_generate(tmp_path):
    a = jcolor.RGBToSpectrumTable.generate(res=3)
    path = str(tmp_path / "t.npy")
    b = tcolor.RGBToSpectrumTable.generate(res=3, cache_path=path)
    assert b.res == a.res == 3 and b.coeffs.shape == (3, 3, 3, 3)
    lam = np.broadcast_to(np.arange(360, 831, 5, dtype=np.float32),
                          (3, 3, 3, 95)).copy()
    close(tcolor.sigmoid_polynomial(b.coeffs, T(lam)),
          jcolor.sigmoid_polynomial(a.coeffs, J(lam)), rtol=0,
          atol=FIT_ATOL)
    again = tcolor.RGBToSpectrumTable.generate(res=3, cache_path=path)
    np.testing.assert_array_equal(again.coeffs.numpy(), b.coeffs.numpy())


# ---------------------------------------------------------------------------
# sensor
# ---------------------------------------------------------------------------

def test_macbeth_reflectances():
    np.testing.assert_array_equal(tsen.MACBETH_SRGB, jsen.MACBETH_SRGB)
    np.testing.assert_array_equal(tsen.macbeth_reflectances(),
                                  jsen.macbeth_reflectances())
    got = tsen.macbeth_reflectances(synthetic=True)
    assert got.shape == (24, 471) and got.dtype == np.float64
    close(got, jsen.macbeth_reflectances(synthetic=True), rtol=0,
          atol=FIT_ATOL)


def test_sensor_keeps_one_white_balance():
    assert not hasattr(tsen, "white_balance_matrix")
    d50 = tdata.ILLUM_D50
    a = jsen.PixelSensor.create(None, sensor_illum=d50)
    b = tsen.PixelSensor.create(None, sensor_illum=d50)
    close(b.xyz_from_sensor_rgb, a.xyz_from_sensor_rgb)
    assert math.isclose(float(np.linalg.det(b.xyz_from_sensor_rgb)),
                        float(np.linalg.det(a.xyz_from_sensor_rgb)),
                        rel_tol=1e-5)
