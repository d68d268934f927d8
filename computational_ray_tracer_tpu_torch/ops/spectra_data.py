"""Spectral data (``computational_ray_tracer_tpu/ops/spectra_data.py``):
the measured tables and the analytic models behind them.

The tables live in this package's own ``ops/data/spectra_tables.npz``, a
byte-for-byte copy of the reference's: the dense 1 nm wavelength grid, the
CIE colour-matching functions, the standard illuminants, the CIE daylight
basis, the metal/glass optical constants, the measured camera sensor curves
and the ColorChecker swatch reflectances. The analytic models (the
multi-lobe Gaussian CIE fits, Planck's law, CIE daylight synthesis,
Sellmeier glass dispersion, a generative fluorescent SPD) are host-side
NumPy, as in the reference; they serve as physics oracles in tests.
"""

from __future__ import annotations

import os

import numpy as np

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_SPECTRUM_SAMPLES = 8

DENSE_LAMBDA = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0, dtype=np.float64)
N_DENSE = DENSE_LAMBDA.shape[0]  # 471

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_T = dict(np.load(os.path.join(DATA_DIR, "spectra_tables.npz")))

CIE_X = _T["cie-x"]
CIE_Y = _T["cie-y"]
CIE_Z = _T["cie-z"]
CIE_Y_INTEGRAL = 106.856895


def _pgauss(lam, mu, s1, s2):
    """Piecewise Gaussian with different left/right widths."""
    t = (lam - mu) / np.where(lam < mu, s1, s2)
    return np.exp(-0.5 * t * t)


def cie_x_fit(lam):
    """Analytic x-bar fit (Wyman, Sloan and Shirley 2013)."""
    lam = np.asarray(lam, dtype=np.float64)
    return (1.056 * _pgauss(lam, 599.8, 37.9, 31.0)
            + 0.362 * _pgauss(lam, 442.0, 16.0, 26.7)
            - 0.065 * _pgauss(lam, 501.1, 20.4, 26.2))


def cie_y_fit(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return (0.821 * _pgauss(lam, 568.8, 46.9, 40.5)
            + 0.286 * _pgauss(lam, 530.9, 16.3, 31.1))


def cie_z_fit(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return (1.217 * _pgauss(lam, 437.0, 11.8, 36.0)
            + 0.681 * _pgauss(lam, 459.0, 26.0, 13.8))


_PLANCK_C = 299792458.0
_PLANCK_H = 6.62606957e-34
_PLANCK_KB = 1.3806488e-23


def blackbody(lam_nm, T):
    """Planck spectral radiance (W / (m^2 sr m)) at lam_nm [nm], T [K]."""
    lam = np.asarray(lam_nm, dtype=np.float64) * 1e-9
    return (2.0 * _PLANCK_H * _PLANCK_C ** 2) / (
        lam ** 5 * np.expm1((_PLANCK_H * _PLANCK_C) / (lam * _PLANCK_KB * T)))


def blackbody_normalized(lam_nm, T):
    """Planck curve scaled so its peak (Wien displacement) equals 1."""
    lam_max_nm = 2.8977721e-3 / T * 1e9
    return blackbody(lam_nm, T) / blackbody(np.array([lam_max_nm]), T)[0]


ILLUM_A = _T["stdillum-A"]
ILLUM_D50 = _T["stdillum-D50"]
ILLUM_D65 = _T["stdillum-D65"]
ILLUM_D60 = _T["illum-acesD60"]
ILLUM_E = np.ones(N_DENSE, dtype=np.float32)
ILLUM_F = {i: _T[f"stdillum-F{i}"] for i in range(1, 13)}

# CIE daylight basis functions on their native 107-sample grid.
CIE_S_LAMBDA = _T["cie-s-lambda"]
CIE_S0, CIE_S1, CIE_S2 = _T["cie-s0"], _T["cie-s1"], _T["cie-s2"]


def d_illuminant(temperature):
    """CIE daylight illuminant D at a temperature, synthesized from the
    S0/S1/S2 basis: the dense (471,) SPD, unnormalized. Below 4000 K, where
    the D series is undefined, a blackbody scaled to peak 100."""
    cct = float(temperature) * 1.4388 / 1.4380
    if cct < 4000.0:
        return (blackbody_normalized(DENSE_LAMBDA, cct) * 100.0
                ).astype(np.float32)
    if cct <= 7000.0:
        x = (-4.607e9 / cct ** 3 + 2.9678e6 / cct ** 2 + 0.09911e3 / cct
             + 0.244063)
    else:
        x = (-2.0064e9 / cct ** 3 + 1.9018e6 / cct ** 2 + 0.24748e3 / cct
             + 0.23704)
    y = -3.0 * x * x + 2.870 * x - 0.275
    m = 0.0241 + 0.2562 * x - 0.7341 * y
    m1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / m
    m2 = (0.0300 - 31.4424 * x + 30.0717 * y) / m
    vals = (CIE_S0.astype(np.float64) + CIE_S1 * m1 + CIE_S2 * m2) * 0.01
    return np.interp(DENSE_LAMBDA, CIE_S_LAMBDA.astype(np.float64), vals,
                     left=0.0, right=0.0).astype(np.float32)


ILLUM_D75 = d_illuminant(7504.0)


def _daylight(cct):
    """Daylight-shaped oracle: a blackbody at the CIE-adjusted temperature,
    100 at 560 nm."""
    s = blackbody(DENSE_LAMBDA, cct * 1.4388 / 1.4380)
    return (s / np.interp(560.0, DENSE_LAMBDA, s) * 100.0).astype(np.float32)


def _fluorescent(cct, line_strength, base_mix):
    """Fluorescent oracle: a broadband phosphor base plus Gaussian mercury
    lines at 404.7/435.8/546.1/578 nm, 100 at 560 nm."""
    base = _daylight(cct).astype(np.float64)
    lines = np.zeros(N_DENSE)
    for mu, rel in ((404.7, 0.35), (435.8, 1.0), (546.1, 0.9), (578.0, 0.5)):
        lines += rel * np.exp(-0.5 * ((DENSE_LAMBDA - mu) / 2.5) ** 2)
    lines = lines / lines.max() * 100.0
    s = base_mix * base + line_strength * lines
    return (s / np.interp(560.0, DENSE_LAMBDA, s) * 100.0).astype(np.float32)


# name: (B1, B2, B3, C1, C2, C3) with C in um^2 (Schott catalog).
_SELLMEIER = {
    "glass-BK7": (1.03961212, 0.231792344, 1.01046945,
                  0.00600069867, 0.0200179144, 103.560653),
    "glass-BAF10": (1.5851495, 0.143559385, 1.08521269,
                    0.00926681282, 0.0424489805, 105.613573),
    "glass-FK51A": (0.971247817, 0.216901417, 0.904651666,
                    0.00472301995, 0.0153575612, 168.68133),
    "glass-LASF9": (2.00029547, 0.298926886, 1.80691843,
                    0.0121426017, 0.0538736236, 156.530829),
    "glass-SF5": (1.52481889, 0.187085527, 1.42729015,
                  0.011254756, 0.0588995392, 129.141675),
    "glass-SF10": (1.62153902, 0.256287842, 1.64447552,
                   0.0122241457, 0.0595736775, 147.468793),
    "glass-SF11": (1.73759695, 0.313747346, 1.89878101,
                   0.013188707, 0.0623068142, 155.23629),
}


def sellmeier_ior(lam_nm, coeffs):
    """Refractive index n(lambda) from Sellmeier coefficients."""
    b1, b2, b3, c1, c2, c3 = coeffs
    lu2 = (np.asarray(lam_nm, dtype=np.float64) * 1e-3) ** 2  # um^2
    return np.sqrt(1.0 + b1 * lu2 / (lu2 - c1) + b2 * lu2 / (lu2 - c2)
                   + b3 * lu2 / (lu2 - c3))


_GLASSES = ("BK7", "BAF10", "FK51A", "LASF9", "SF5", "SF10", "SF11")
_METALS = ("Ag", "Al", "Au", "Cu", "CuZn", "MgO", "TiO2")
GLASS_IOR = {f"glass-{g}": _T[f"glass-{g}-eta"] for g in _GLASSES}
METAL_ETA = {f"metal-{m}": _T[f"metal-{m}-eta"] for m in _METALS}
METAL_K = {f"metal-{m}": _T[f"metal-{m}-k"] for m in _METALS}

# Camera sensor r/g/b responses (17 camera models), by sensor name.
_SENSOR_NAMES = sorted({k[:-2] for k in _T if k.endswith(("_r", "_g", "_b"))})
SENSOR_CURVES = {name: (_T[f"{name}_r"], _T[f"{name}_g"], _T[f"{name}_b"])
                 for name in _SENSOR_NAMES}
# The 24 ColorChecker swatch reflectances (24, 471): the named sensors'
# calibration set.
MACBETH_SWATCHES = _T["macbeth-swatches"]

NAMED_SPECTRA = {
    "stdillum-A": ILLUM_A, "stdillum-D50": ILLUM_D50,
    "stdillum-D65": ILLUM_D65, "stdillum-acesD60": ILLUM_D60,
    "illum-acesD60": ILLUM_D60, "stdillum-E": ILLUM_E,
    "cie-x": CIE_X, "cie-y": CIE_Y, "cie-z": CIE_Z,
}
for _i in range(1, 13):
    NAMED_SPECTRA[f"stdillum-F{_i}"] = ILLUM_F[_i]
for _name, _v in GLASS_IOR.items():
    NAMED_SPECTRA[_name + "-eta"] = _v
# The reference registers the SF glasses as glass-F5/F10/F11 too.
for _g in ("F5", "F10", "F11"):
    NAMED_SPECTRA[f"glass-{_g}-eta"] = GLASS_IOR[f"glass-S{_g}"]
    NAMED_SPECTRA[f"glass-{_g}"] = GLASS_IOR[f"glass-S{_g}"]
for _name in METAL_ETA:
    NAMED_SPECTRA[_name + "-eta"] = METAL_ETA[_name]
    NAMED_SPECTRA[_name + "-k"] = METAL_K[_name]
for _name in _SENSOR_NAMES:
    for _ch in "rgb":
        NAMED_SPECTRA[f"{_name}_{_ch}"] = _T[f"{_name}_{_ch}"]


def get_named_spectrum(name: str) -> np.ndarray:
    """Dense (471,) float32 SPD for a registered spectrum name."""
    return NAMED_SPECTRA[name]
