"""Pixel sensor (``computational_ray_tracer_tpu/ops/sensor.py``): spectral
radiance -> sensor RGB through three response curves, then sensor RGB ->
XYZ through a 3x3 matrix.

The default sensor (no name) matches XYZ: its curves are the CIE CMFs and
its matrix the identity, or a Bradford white balance from a sensor
illuminant to the sRGB whitepoint. A named sensor takes the measured
curves of one of 17 cameras (``spectra_data.SENSOR_CURVES``); its matrix
is the least-squares fit, in float64 on the host, of the 24 ColorChecker
swatches' XYZ under D65 (the sRGB illuminant) to their sensor RGB under
the sensor illuminant (D65 by default). The output colour space
(sRGB by default) sets the white balance's target and the swatches'
illuminant; the imaging ratio scales the sensor RGB (1 in the renders).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import color as colorlib
from computational_ray_tracer_tpu_torch.ops import spectra_data as data
from computational_ray_tracer_tpu_torch.ops import spectrum as spec

# Classic X-Rite ColorChecker 24 patch sRGB values (8-bit).
MACBETH_SRGB = np.array([
    [115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67],
    [133, 128, 177], [103, 189, 170], [214, 126, 44], [80, 91, 166],
    [193, 90, 99], [94, 60, 108], [157, 188, 64], [224, 163, 46],
    [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31],
    [187, 86, 149], [8, 133, 161], [243, 243, 242], [200, 200, 200],
    [160, 160, 160], [122, 122, 122], [85, 85, 85], [52, 52, 52],
], dtype=np.float64) / 255.0

_SWATCH_CACHE = {}


def macbeth_reflectances(synthetic=False):
    """(24, 471) float64 reflectances of the ColorChecker patches: the
    measured swatches, or with ``synthetic`` the published sRGB patch
    values lifted to spectra through the sigmoid fit (an oracle)."""
    if not synthetic:
        return np.asarray(data.MACBETH_SWATCHES, dtype=np.float64)
    if "swatches" not in _SWATCH_CACHE:
        lin = colorlib.srgb_to_linear(torch.as_tensor(MACBETH_SRGB,
                                                      dtype=torch.float32))
        coeffs = colorlib.fit_rgb_to_spectrum(lin)
        lam = spec.dense_lambda()
        refl = colorlib.sigmoid_polynomial(coeffs, lam.expand(24, -1))
        _SWATCH_CACHE["swatches"] = refl.numpy().astype(np.float64)
    return _SWATCH_CACHE["swatches"]


def _illum_xyz(illum):
    illum = np.asarray(illum, np.float64)
    return np.array([np.sum(illum * c) for c in
                     (data.CIE_X, data.CIE_Y, data.CIE_Z)])


def _project_reflectance(refl, illum, curves):
    """The integrals of refl * illum * each curve, normalized so that a
    perfect reflector has second channel 1."""
    out = np.stack([np.sum(refl * illum * b, axis=-1) for b in curves],
                   axis=-1)
    return out / np.sum(illum * curves[1])


@dataclasses.dataclass(frozen=True)
class PixelSensor:
    curves: np.ndarray               # (3, 471) response curves
    xyz_from_sensor_rgb: np.ndarray  # (3, 3)
    imaging_ratio: float = 1.0

    @classmethod
    def create(cls, sensor_name=None, colorspace=None, sensor_illum=None,
               imaging_ratio=1.0):
        """The reference's ``PixelSensor.create``: ``sensor_name=None`` is
        the XYZ-matching sensor, white-balanced from ``sensor_illum`` to
        the whitepoint of ``colorspace`` (None: sRGB); a name from
        ``SENSOR_CURVES`` is that camera, calibrated on the ColorChecker
        swatches under the colour space's illuminant. ``sensor_illum``: a
        dense (471,) illuminant."""
        cs = colorspace or colorlib.SRGB
        ratio = float(imaging_ratio)
        if sensor_name is None:
            curves = np.stack([data.CIE_X, data.CIE_Y, data.CIE_Z])
            m = np.eye(3, dtype=np.float32)
            if sensor_illum is not None:
                src = _illum_xyz(sensor_illum)
                m = colorlib.white_balance_matrix(tuple(src[:2] / src.sum()),
                                                  cs.w)
            return cls(curves.astype(np.float32), m, ratio)
        curves = np.stack(data.SENSOR_CURVES[sensor_name]).astype(np.float64)
        illum = np.asarray(data.ILLUM_D65 if sensor_illum is None
                           else sensor_illum, np.float64)
        refl = macbeth_reflectances()
        rgb_cam = _project_reflectance(refl, illum, curves)
        cmf = [np.asarray(c, np.float64)
               for c in (data.CIE_X, data.CIE_Y, data.CIE_Z)]
        xyz = _project_reflectance(refl, np.asarray(cs.illuminant,
                                                    np.float64), cmf)
        m, *_ = np.linalg.lstsq(rgb_cam, xyz, rcond=None)
        return cls(curves.astype(np.float32), m.T.astype(np.float32), ratio)

    def to_sensor_rgb(self, L, wl):
        """(..., S) radiance + wavelengths -> (..., 3) sensor RGB:
        imaging ratio x mean over λ of b̄(λ)·L/pdf / ∫ȳ."""
        w = spec.safe_div(L, wl.pdf)
        curves = self._on(L.device)[0]
        bars = spec.sample_dense_multi(curves, wl.lam)       # (..., S, 3)
        rgb = torch.mean(bars * w[..., None], dim=-2)
        if self.imaging_ratio != 1.0:     # x 1.0: no bit changes, no launch
            rgb = self.imaging_ratio * rgb
        return rgb / spec.CIE_Y_INTEGRAL

    def sensor_rgb_to_xyz(self, rgb):
        return rgb @ self._on(rgb.device)[1].T

    def _on(self, device):
        """(curves (471, 3), xyz_from_sensor_rgb) as tensors on ``device``,
        built once per device and kept: a pass makes no host copy."""
        kept = self.__dict__.setdefault("_tensors", {})
        key = str(device)
        if key not in kept:
            kept[key] = (torch.as_tensor(self.curves.T.copy(), device=device),
                         torch.as_tensor(self.xyz_from_sensor_rgb,
                                         device=device))
        return kept[key]
