"""Pixel sensor (``computational_ray_tracer_tpu/ops/sensor.py``): the
default XYZ-matching sensor and the per-sample spectral -> sensor RGB step.
Named camera sensors (ColorChecker least-squares calibration) are not part
of the slice."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import spectra_data as data
from computational_ray_tracer_tpu_torch.ops import spectrum as spec


@dataclasses.dataclass(frozen=True)
class PixelSensor:
    curves: np.ndarray               # (3, 471) response curves
    xyz_from_sensor_rgb: np.ndarray  # (3, 3)

    @classmethod
    def create(cls):
        """The reference's ``create(None)``: curves are the CIE CMFs and the
        matrix is the identity (no sensor illuminant, imaging ratio 1)."""
        curves = np.stack([data.CIE_X, data.CIE_Y, data.CIE_Z])
        return cls(curves.astype(np.float32), np.eye(3, dtype=np.float32))

    def to_sensor_rgb(self, L, wl):
        """(..., S) radiance + wavelengths -> (..., 3) sensor RGB:
        mean over λ of b̄(λ)·L/pdf / ∫ȳ."""
        w = spec.safe_div(L, wl.pdf)
        curves = torch.as_tensor(self.curves.T.copy(), device=L.device)
        bars = spec.sample_dense_multi(curves, wl.lam)       # (..., S, 3)
        rgb = torch.mean(bars * w[..., None], dim=-2)
        return rgb / spec.CIE_Y_INTEGRAL

    def sensor_rgb_to_xyz(self, rgb):
        m = torch.as_tensor(self.xyz_from_sensor_rgb, device=rgb.device)
        return rgb @ m.T
