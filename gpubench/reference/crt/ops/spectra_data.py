"""Spectral data (``computational_ray_tracer_tpu/ops/spectra_data.py``):
the measured tables.

The tables live in this package's own ``ops/data/spectra_tables.npz``, a
byte-for-byte copy of the reference's: the dense 1 nm wavelength grid, the
CIE colour-matching functions, the standard illuminants and the
metal/glass optical constants (the camera sensor curves and swatches in it
are not read here).
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


ILLUM_A = _T["stdillum-A"]
ILLUM_D50 = _T["stdillum-D50"]
ILLUM_D65 = _T["stdillum-D65"]
ILLUM_D60 = _T["illum-acesD60"]
ILLUM_E = np.ones(N_DENSE, dtype=np.float32)
ILLUM_F = {i: _T[f"stdillum-F{i}"] for i in range(1, 13)}

_GLASSES = ("BK7", "BAF10", "FK51A", "LASF9", "SF5", "SF10", "SF11")
_METALS = ("Ag", "Al", "Au", "Cu", "CuZn", "MgO", "TiO2")
GLASS_IOR = {f"glass-{g}": _T[f"glass-{g}-eta"] for g in _GLASSES}
METAL_ETA = {f"metal-{m}": _T[f"metal-{m}-eta"] for m in _METALS}
METAL_K = {f"metal-{m}": _T[f"metal-{m}-k"] for m in _METALS}

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


def get_named_spectrum(name: str) -> np.ndarray:
    """Dense (471,) float32 SPD for a registered spectrum name."""
    return NAMED_SPECTRA[name]
