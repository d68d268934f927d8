"""Colour science (``computational_ray_tracer_tpu/ops/color.py``):
chromaticity, the sRGB, DCI-P3, Rec. 2020 and ACES2065-1 colour spaces,
Bradford white balance, the sRGB transfer functions, sigmoid-polynomial
spectra and the RGB -> sigmoid-coefficient fit, and the precomputed sRGB
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


def xyY_to_xyz(xy, Y=1.0):
    """XYZ from chromaticity xy (..., 2) and luminance Y; 0 where y = 0."""
    x, y = xy[..., 0], xy[..., 1]
    Y = torch.as_tensor(Y, dtype=xy.dtype, device=xy.device)
    safe = y != 0.0
    ys = torch.where(safe, y, torch.ones_like(y))
    zero = torch.zeros_like(x)
    return torch.stack([torch.where(safe, x * Y / ys, zero),
                        torch.where(safe, Y, zero),
                        torch.where(safe, (1.0 - x - y) * Y / ys, zero)], -1)


def xyz_chromaticity(xyz):
    """(x, y) of XYZ (..., 3)."""
    return xyz[..., :2] / torch.sum(xyz, dim=-1, keepdim=True)


def _apply(m, v):
    """The 3x3 float64 host matrix m applied to v (..., 3) in float32."""
    return v @ torch.as_tensor(m, dtype=torch.float32, device=v.device).T


@dataclasses.dataclass(frozen=True)
class RGBColorSpace:
    """An RGB colour space from primary + whitepoint chromaticities; the
    matrices are derived in float64 on the host."""
    name: str
    r: tuple
    g: tuple
    b: tuple
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
        return cls(name, r, g, b, w, xyz_from_rgb,
                   np.linalg.inv(xyz_from_rgb),
                   np.asarray(illuminant, dtype=np.float32))

    def to_rgb(self, xyz):
        return _apply(self.rgb_from_xyz, xyz)

    def to_xyz(self, rgb):
        return _apply(self.xyz_from_rgb, rgb)


SRGB = RGBColorSpace.create(
    "sRGB", (0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.3127, 0.3290),
    data.ILLUM_D65)
DCI_P3 = RGBColorSpace.create(
    "DCI-P3", (0.680, 0.320), (0.265, 0.690), (0.150, 0.060), (0.314, 0.351),
    data.ILLUM_D65)
REC_2020 = RGBColorSpace.create(
    "Rec2020", (0.708, 0.292), (0.170, 0.797), (0.131, 0.046),
    (0.3127, 0.3290), data.ILLUM_D65)
ACES2065_1 = RGBColorSpace.create(
    "ACES2065-1", (0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.077),
    (0.32168, 0.33767), data.ILLUM_D60)

COLOR_SPACES = {cs.name: cs for cs in (SRGB, DCI_P3, REC_2020, ACES2065_1)}


def convert_rgb_colorspace(rgb, src: RGBColorSpace, dst: RGBColorSpace):
    """RGB (..., 3) of colour space src in colour space dst."""
    return _apply(dst.rgb_from_xyz @ src.xyz_from_rgb, rgb)


# Bradford cone response, XYZ -> LMS.
_LMS_FROM_XYZ = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296]], dtype=np.float64)
_XYZ_FROM_LMS = np.linalg.inv(_LMS_FROM_XYZ)


def white_balance_matrix(src_xy, dst_xy):
    """3x3 XYZ -> XYZ Bradford adaptation from whitepoint src to dst (the
    whitepoints' XYZ in float32, as the reference takes them)."""
    src, dst = (xyY_to_xyz(torch.tensor(xy, dtype=torch.float32)).numpy()
                for xy in (src_xy, dst_xy))
    lms_s = _LMS_FROM_XYZ @ src
    lms_d = _LMS_FROM_XYZ @ dst
    return (_XYZ_FROM_LMS @ np.diag(lms_d / lms_s) @ _LMS_FROM_XYZ).astype(
        np.float32)


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(torch.clamp(c, min=1e-7), 1.0 / 2.4)
                       - 0.055)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


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
    def from_rgb(cls, rgb, colorspace=SRGB):
        return cls(fit_rgb_to_spectrum(rgb, colorspace))

    def __call__(self, lam):
        return sigmoid_polynomial(self.coeffs, lam)


def _scaled_fit(rgb, colorspace):
    """(coefficients, scale) of RGB (..., 3) outside [0, 1]: the fit of
    rgb / (2 max(rgb)) and the scale 2 max(rgb)."""
    rgb = torch.as_tensor(np.asarray(rgb, np.float32))
    scale = 2.0 * torch.clamp(torch.max(rgb, dim=-1).values, min=1e-6)
    return fit_rgb_to_spectrum(rgb / scale[..., None], colorspace), scale


@dataclasses.dataclass
class RGBUnboundedSpectrum:
    """Scaled sigmoid spectrum for RGB outside [0, 1]."""
    coeffs: torch.Tensor
    scale: torch.Tensor

    @classmethod
    def from_rgb(cls, rgb, colorspace=SRGB):
        return cls(*_scaled_fit(rgb, colorspace))

    def __call__(self, lam):
        s = self.scale[..., None] if self.scale.ndim else self.scale
        return s * sigmoid_polynomial(self.coeffs, lam)


@dataclasses.dataclass
class RGBIlluminantSpectrum:
    """Illuminant-shaped emission for an RGB colour: a scaled reflectance
    fit times the colour space's illuminant."""
    coeffs: torch.Tensor
    scale: torch.Tensor
    illuminant: torch.Tensor

    @classmethod
    def from_rgb(cls, rgb, colorspace=SRGB):
        coeffs, scale = _scaled_fit(rgb, colorspace)
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
    def generate(cls, res=32, colorspace=SRGB, cache_path=None):
        """Fit a res^3 grid of RGB cell centres, or load ``cache_path``
        when it exists (and save the fit there when it does not)."""
        if cache_path and os.path.exists(cache_path):
            return cls(res, torch.as_tensor(np.load(cache_path)))
        g = (np.arange(res, dtype=np.float32) + 0.5) / res
        grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
        coeffs = fit_rgb_to_spectrum(grid, colorspace)
        if cache_path:
            np.save(cache_path, coeffs.numpy())
        return cls(res, coeffs)

    @classmethod
    def srgb(cls):
        """The shipped 64^3 sRGB table, ``ops/data/rgb2spec_srgb_64.npy``
        (a copy of the reference's; no fitting)."""
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
