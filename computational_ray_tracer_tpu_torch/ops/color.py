"""Colour science for the slice (``computational_ray_tracer_tpu/ops/
color.py``): the sRGB colour space, sigmoid-polynomial spectra and the
RGB -> sigmoid-coefficient fit, and the reference's precomputed sRGB
coefficient table for textures.

The fit is scene-build work on the host: a batched Levenberg-Marquardt solve
in float32 over the same 5 nm quadrature as the reference. The reference
takes the Jacobian with ``jax.jacfwd``; here it is the closed form of the
same derivative, so coefficients can differ from the reference's in the last
bits.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import spectra_data as data
from computational_ray_tracer_tpu_torch.ops import spectrum as spec


@dataclasses.dataclass(frozen=True)
class RGBColorSpace:
    """An RGB colour space from primary + whitepoint chromaticities; the
    matrices are derived in float64 on the host."""
    name: str
    w: tuple
    xyz_from_rgb: np.ndarray
    rgb_from_xyz: np.ndarray
    illuminant: np.ndarray  # dense (471,) SPD of the whitepoint illuminant

    @classmethod
    def create(cls, name, r, g, b, w, illuminant):
        def xyY(xy):
            x, y = xy
            return np.array([x / y, 1.0, (1 - x - y) / y], dtype=np.float64)
        M = np.stack([xyY(r), xyY(g), xyY(b)], axis=1)
        xyz_from_rgb = M * np.linalg.solve(M, xyY(w))[None, :]
        return cls(name, w, xyz_from_rgb, np.linalg.inv(xyz_from_rgb),
                   np.asarray(illuminant, dtype=np.float32))

    def to_rgb(self, xyz):
        m = torch.as_tensor(self.rgb_from_xyz, dtype=torch.float32,
                            device=xyz.device)
        return xyz @ m.T


SRGB = RGBColorSpace.create(
    "sRGB", (0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.3127, 0.3290),
    data.ILLUM_D65)


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(torch.clamp(c, min=1e-7), 1.0 / 2.4)
                       - 0.055)


def _sigmoid(x):
    return 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))


def _lam_norm(lam):
    return (lam - spec.LAMBDA_MIN) / (spec.LAMBDA_MAX - spec.LAMBDA_MIN) \
        * 2.0 - 1.0


def sigmoid_polynomial(coeffs, lam):
    """Reflectance s(c2 t^2 + c1 t + c0), t the normalized wavelength.
    ``coeffs`` (..., 3) broadcasts against ``lam``'s batch dims."""
    t = _lam_norm(lam)
    p = (coeffs[..., 2:3] * t + coeffs[..., 1:2]) * t + coeffs[..., 0:1]
    return _sigmoid(p)


@dataclasses.dataclass
class RGBAlbedoSpectrum:
    """Bounded reflectance spectrum from sigmoid coefficients."""
    coeffs: torch.Tensor

    @classmethod
    def from_rgb(cls, rgb):
        return cls(fit_rgb_to_spectrum(rgb))

    def __call__(self, lam):
        return sigmoid_polynomial(self.coeffs, lam)


@dataclasses.dataclass
class RGBIlluminantSpectrum:
    """Illuminant-shaped emission for an RGB colour: a scaled reflectance
    fit times the colour space's illuminant."""
    coeffs: torch.Tensor
    scale: torch.Tensor
    illuminant: torch.Tensor

    @classmethod
    def from_rgb(cls, rgb, colorspace=SRGB):
        rgb = torch.as_tensor(np.asarray(rgb, np.float32))
        scale = 2.0 * torch.clamp(torch.max(rgb, dim=-1).values, min=1e-6)
        coeffs = fit_rgb_to_spectrum(rgb / scale[..., None])
        return cls(coeffs, scale, torch.as_tensor(colorspace.illuminant))

    def __call__(self, lam):
        s = self.scale[..., None] if self.scale.ndim else self.scale
        return (s * sigmoid_polynomial(self.coeffs, lam)
                * spec.sample_dense(self.illuminant, lam))


_FIT_LAM = np.arange(360.0, 831.0, 5.0, dtype=np.float32)


def _fit_tables(colorspace):
    lamf = _FIT_LAM.astype(np.float64)
    illum = np.interp(lamf, data.DENSE_LAMBDA, colorspace.illuminant)
    cmf = np.stack([np.interp(lamf, data.DENSE_LAMBDA, c)
                    for c in (data.CIE_X, data.CIE_Y, data.CIE_Z)])
    cmf_w = cmf / np.sum(illum * cmf[1])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return f(illum), f(cmf_w), f(colorspace.rgb_from_xyz)


def fit_rgb_to_spectrum(rgb, colorspace=SRGB, n_iter=40):
    """Sigmoid-polynomial coefficients (..., 3) for RGB reflectances
    (..., 3): batched Levenberg-Marquardt on the 3-residual round trip
    (40 iterations, damping halved on success and x4 on failure)."""
    rgb = torch.as_tensor(np.asarray(rgb, np.float32))
    shape = rgb.shape
    target = rgb.reshape(-1, 3)
    illum, cmf_w, m = _fit_tables(colorspace)
    t = _lam_norm(torch.as_tensor(_FIT_LAM))                    # (L,)
    basis = torch.stack([torch.ones_like(t), t, t * t], dim=-1)  # (L, 3)

    def roundtrip(c):                                           # (B, 3)
        p = (c[:, 2:3] * t + c[:, 1:2]) * t + c[:, 0:1]         # (B, L)
        xyz = (_sigmoid(p) * illum) @ cmf_w.T
        return xyz @ m.T, p

    y = torch.clamp(target.sum(-1) / 3.0, 1e-4, 1.0 - 1e-4)
    c = torch.stack([torch.log(y / (1.0 - y)), torch.zeros_like(y),
                     torch.zeros_like(y)], dim=-1)
    lm = torch.full_like(y, 1e-2)
    eye = torch.eye(3, dtype=torch.float32)
    for _ in range(n_iter):
        rgb_c, p = roundtrip(c)
        r = rgb_c - target
        ds = 0.5 / torch.pow(1.0 + p * p, 1.5)                  # (B, L)
        dr = ds[..., None] * basis                              # (B, L, 3)
        J = m @ (cmf_w @ (illum[:, None] * dr))                 # (B, 3, 3)
        Jt = J.transpose(-1, -2)
        A = Jt @ J + lm[:, None, None] * eye
        delta = torch.linalg.solve(A, (Jt @ r[..., None]))[..., 0]
        c_new = c - delta
        better = ((roundtrip(c_new)[0] - target) ** 2).sum(-1) \
            < (r ** 2).sum(-1)
        c = torch.where(better[:, None], c_new, c)
        lm = torch.clamp(torch.where(better, lm * 0.5, lm * 4.0), 1e-8, 1e4)
    return c.reshape(shape)


_TABLES = {}


@dataclasses.dataclass(frozen=True)
class RGBToSpectrumTable:
    """A (res, res, res, 3) grid of sigmoid coefficients over RGB,
    trilinearly interpolated at lookup (the reference's
    ``RGBToSpectrumTable``)."""
    res: int
    coeffs: torch.Tensor  # (res, res, res, 3)

    @classmethod
    def srgb(cls):
        """The reference's shipped 64^3 sRGB table, read by path from its
        data directory (no fitting)."""
        if "srgb64" not in _TABLES:
            path = os.path.join(data.DATA_DIR, "rgb2spec_srgb_64.npy")
            coeffs = torch.as_tensor(np.load(path).astype(np.float32))
            _TABLES["srgb64"] = cls(coeffs.shape[0], coeffs)
        return _TABLES["srgb64"]

    def lookup(self, rgb):
        """Trilinear interpolation of the coefficients at rgb in [0, 1]^3
        (rgb (..., 3) on the CPU, as the table is)."""
        r = self.res
        x = torch.clamp(rgb, 0.0, 1.0) * r - 0.5
        i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, r - 2)
        w = torch.clamp(x - i0, 0.0, 1.0)
        c = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    wt = ((w[..., 0] if dx else 1 - w[..., 0])
                          * (w[..., 1] if dy else 1 - w[..., 1])
                          * (w[..., 2] if dz else 1 - w[..., 2]))
                    c = c + wt[..., None] * self.coeffs[
                        i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]
        return c
