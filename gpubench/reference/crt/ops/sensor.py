"""Pixel sensor (``computational_ray_tracer_tpu/ops/sensor.py``), the
default (unnamed) one: spectral radiance -> sensor RGB through the CIE
CMFs, then sensor RGB -> XYZ through the identity matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.reference.crt.ops import spectra_data as data
from gpubench.reference.crt.ops import spectrum as spec


@dataclasses.dataclass(frozen=True)
class PixelSensor:
    curves: np.ndarray               # (3, 471) response curves
    xyz_from_sensor_rgb: np.ndarray  # (3, 3)

    @classmethod
    def create(cls):
        """The reference's ``PixelSensor.create()``: the XYZ-matching
        sensor with no white balance."""
        curves = np.stack([data.CIE_X, data.CIE_Y, data.CIE_Z])
        return cls(curves.astype(np.float32), np.eye(3, dtype=np.float32))

    def to_sensor_rgb(self, L, wl):
        """(..., S) radiance + wavelengths -> (..., 3) sensor RGB:
        mean over λ of b̄(λ)·L/pdf / ∫ȳ."""
        w = spec.safe_div(L, wl.pdf)
        curves = self._on(L.device)[0]
        bars = spec.sample_dense_multi(curves, wl.lam)       # (..., S, 3)
        rgb = torch.mean(bars * w[..., None], dim=-2)
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
