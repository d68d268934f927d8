"""Hero-wavelength spectral core (``computational_ray_tracer_tpu/ops/
spectrum.py``): sampled wavelengths, dense-table interpolation, the
spectrum classes (constant, dense, piecewise linear, blackbody), CIE XYZ
and photometric quadrature.

A sampled spectrum is a float32 tensor with a trailing axis of 8 hero
wavelengths. Dense 1 nm tables over [360, 830] are interpolated with a
gather and a lerp. :func:`sample_dense_multi`, which every pass calls for
its spectral cache and its sensor, goes through ``ops/interp_kernel.py``:
the CUDA interpolation kernel on the card, its plain version on the CPU;
the table's gradient (the emission and light spectra of inverse
rendering) goes through the kernel's backward, a CUDA kernel too.
On the card it launches for every call, whatever the size (the reference
keeps its TPU kernel opt-in because inside one fused XLA program it was a
fusion barrier; in eager PyTorch one kernel replaces a chain of gathers and
lerps and breaks no fusion).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import interp_kernel as ik
from computational_ray_tracer_tpu_torch.ops import spectra_data as data

LAMBDA_MIN = data.LAMBDA_MIN
LAMBDA_MAX = data.LAMBDA_MAX
N_SPECTRUM_SAMPLES = data.N_SPECTRUM_SAMPLES
CIE_Y_INTEGRAL = data.CIE_Y_INTEGRAL


def safe_div(a, b):
    """a/b with 0 where b == 0."""
    nz = b != 0.0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)),
                       torch.zeros_like(a))


@dataclasses.dataclass
class SampledWavelengths:
    """Hero wavelengths + their sampling pdf, each (..., S)."""
    lam: torch.Tensor
    pdf: torch.Tensor

    def terminate_secondary(self):
        """Collapse to the hero wavelength (dispersive paths): pdf
        [p0 / S, 0, ...] unless already collapsed."""
        s = self.lam.shape[-1]
        new_pdf = torch.cat([self.pdf[..., :1] / s,
                             torch.zeros_like(self.pdf[..., 1:])], dim=-1)
        pdf = torch.where(self.secondary_terminated()[..., None], self.pdf,
                          new_pdf)
        return SampledWavelengths(self.lam, pdf)

    def secondary_terminated(self):
        return torch.all(self.pdf[..., 1:] == 0.0, dim=-1)


def average(s):
    """Mean over the wavelength axis."""
    return torch.mean(s, dim=-1)


def spectrum_clamp(s, lo=0.0, hi=math.inf):
    return torch.clamp(s, lo, hi)


def spectrum_lerp(t, a, b):
    """a + (b - a) t, with t broadcast over the wavelength axis when it has
    one dimension fewer than a."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    if t.ndim == a.ndim - 1:
        t = t[..., None]
    return a + (b - a) * t


def visible_wavelengths_pdf(lam):
    x = torch.cosh(0.0072 * (lam - 538.0))
    pdf = 0.0039398042 / (x * x)
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return torch.where(inside, pdf, torch.zeros_like(pdf))


def sample_visible_wavelength(u):
    """Inverse-CDF sample of the visible-importance distribution."""
    return 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * u)


def sample_visible_wavelengths(u, n=N_SPECTRUM_SAMPLES):
    """Stratified importance-sampled hero wavelengths: slot i uses
    wrap(u + i/n) through the visible inverse CDF."""
    i = torch.arange(n, dtype=u.dtype, device=u.device)
    up = u[..., None] + (i + 0.0) / n
    up = torch.where(up > 1.0, up - 1.0, up)
    lam = sample_visible_wavelength(up)
    return SampledWavelengths(lam, visible_wavelengths_pdf(lam))


def sample_uniform_wavelengths(u, lam_min=LAMBDA_MIN, lam_max=LAMBDA_MAX,
                               n=N_SPECTRUM_SAMPLES):
    """Stratified uniform hero wavelengths over [lam_min, lam_max] from one
    u in [0, 1): lam0 = lerp(u), the others advance by (lam_max - lam_min)
    / n nm and wrap."""
    span = lam_max - lam_min
    lam0 = lam_min + u[..., None] * span
    lam = lam0 + torch.arange(n, dtype=lam0.dtype, device=u.device) * (
        span / n)
    lam = torch.where(lam > lam_max, lam_min + (lam - lam_max), lam)
    return SampledWavelengths(lam, torch.full_like(lam, 1.0 / span))


def _dense_idx_frac(lam):
    x = lam - LAMBDA_MIN
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, data.N_DENSE - 2)
    w = torch.clamp(x - i0.to(lam.dtype), 0.0, 1.0)
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return i0, w, inside


def sample_dense(table, lam):
    """Interpolate one dense (471,) table at wavelengths ``lam``; 0 outside
    [360, 830]."""
    i0, w, inside = _dense_idx_frac(lam)
    v = table[i0] * (1.0 - w) + table[i0 + 1] * w
    return torch.where(inside, v, torch.zeros_like(v))


def sample_dense_multi(tables, lam):
    """C dense SPDs at once: tables (471, C), lam (..., S) -> (..., S, C),
    through the interpolation kernel's wrapper; 0 outside [360, 830]."""
    i0, w, inside = _dense_idx_frac(lam)
    c = tables.shape[1]
    v = ik.dense_interp(tables.contiguous(), i0.reshape(-1).to(torch.int32),
                        w.reshape(-1).contiguous()).reshape(lam.shape + (c,))
    return torch.where(inside[..., None], v, torch.zeros_like(v))


_DENSE_T = {}


def dense_lambda(device="cpu"):
    """The dense 1 nm grid (471,) as float32 on ``device`` (cached)."""
    key = str(device)
    if key not in _DENSE_T:
        _DENSE_T[key] = torch.as_tensor(data.DENSE_LAMBDA.astype(np.float32),
                                        device=device)
    return _DENSE_T[key]


@dataclasses.dataclass
class ConstantSpectrum:
    c: Any

    def __call__(self, lam):
        return torch.broadcast_to(
            torch.as_tensor(self.c, dtype=lam.dtype, device=lam.device),
            lam.shape)

    def max_value(self):
        return torch.as_tensor(self.c)


@dataclasses.dataclass
class DenselySampledSpectrum:
    """A dense 1 nm table over [360, 830]."""
    values: torch.Tensor  # (471,)

    @classmethod
    def from_named(cls, name: str, device="cpu"):
        return cls(torch.as_tensor(data.get_named_spectrum(name),
                                   device=device))

    @classmethod
    def from_spectrum(cls, spec, device="cpu"):
        return cls(spec(dense_lambda(device)))

    def __call__(self, lam):
        return sample_dense(self.values, lam)

    def max_value(self):
        return torch.max(self.values)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: piecewise-linear through (xp, fp),
    clamped to fp's end values outside [xp[0], xp[-1]]."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    flat = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    dxs = torch.where(flat, torch.ones_like(dx), dx)
    f = torch.where(flat, fp[i - 1],
                    fp[i - 1] + ((x - xp[i - 1]) / dxs) * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass
class PiecewiseLinearSpectrum:
    """Sorted (lambda, value) control points, linear in between, 0
    outside."""
    lams: torch.Tensor
    values: torch.Tensor

    @classmethod
    def from_interleaved(cls, samples, normalize=False, device="cpu"):
        """Alternating [lam0, v0, lam1, v1, ...]; ``normalize`` scales the
        values to luminance 1 (inner product with y-bar = its integral)."""
        samples = np.asarray(samples, dtype=np.float32)
        lams, vals = (np.ascontiguousarray(samples[k::2]) for k in (0, 1))
        t = lambda a: torch.as_tensor(a, device=device)
        if normalize:
            ybar = DenselySampledSpectrum(t(data.CIE_Y))
            scale = CIE_Y_INTEGRAL / inner_product(
                cls(t(lams), t(vals)), ybar, device)
            vals = vals * float(scale)
        return cls(t(lams), t(vals))

    def __call__(self, lam):
        v = _interp(lam, self.lams, self.values)
        inside = (lam >= self.lams[0]) & (lam <= self.lams[-1])
        return torch.where(inside, v, torch.zeros_like(v))

    def max_value(self):
        return torch.max(self.values)


@dataclasses.dataclass
class BlackbodySpectrum:
    """Planck emitter normalized to peak 1 through Wien's displacement law
    (differentiable in T)."""
    T: Any

    def __call__(self, lam):
        T = torch.as_tensor(self.T, dtype=torch.float32, device=lam.device)
        c, h, kb = 299792458.0, 6.62606957e-34, 1.3806488e-23
        lam_m = lam * 1e-9
        le = (2.0 * h * c * c) / (lam_m ** 5 * torch.expm1(
            (h * c) / (lam_m * kb * T)))
        lam_max = 2.8977721e-3 / T
        norm = (2.0 * h * c * c) / (lam_max ** 5 * torch.expm1(
            (h * c) / (lam_max * kb * T)))
        return le / norm

    def max_value(self):
        return torch.tensor(1.0)


def inner_product(f, g, device="cuda"):
    """The sum of f(lam) g(lam) over the dense 1 nm grid (pbrt's
    InnerProduct); ``device`` is where the spectra's tables are."""
    lam = dense_lambda(device)
    return torch.sum(f(lam) * g(lam))


def sample_dense_rows(table, rows, lam):
    """Per-ray rows of a dense (M, 471) table: rows (...,), lam (..., S) ->
    (..., S). Out-of-range rows are clamped to [0, M)."""
    m = table.shape[0]
    rows = torch.clamp(rows, 0, m - 1).to(torch.int64)
    i0, w, inside = _dense_idx_frac(lam)
    base = rows[..., None] * data.N_DENSE
    flat = table.reshape(-1)
    v = flat[base + i0] * (1.0 - w) + flat[base + i0 + 1] * w
    return torch.where(inside, v, torch.zeros_like(v))


_CIE_T = {}


def cie_tables(device):
    """(471, 3) CIE x̄ȳz̄ on ``device`` (cached per device)."""
    key = str(device)
    if key not in _CIE_T:
        _CIE_T[key] = torch.as_tensor(
            np.stack([data.CIE_X, data.CIE_Y, data.CIE_Z], axis=1)
            .astype(np.float32), device=device)
    return _CIE_T[key]


def cie_xyz_at(lam):
    """(..., S) -> (..., S, 3) colour-matching values."""
    tab = cie_tables(lam.device)
    return torch.stack([sample_dense(tab[:, k], lam) for k in range(3)],
                       dim=-1)


def sampled_to_xyz(s, wl: SampledWavelengths):
    """MC estimate of the XYZ of a sampled spectrum."""
    cmf = cie_xyz_at(wl.lam)
    w = safe_div(s, wl.pdf)[..., None]
    return torch.mean(cmf * w, dim=-2) / CIE_Y_INTEGRAL


def sample_dense_rows_multi(tables, rows, lam):
    """Per-ray rows of several (M, 471) tables at the same wavelengths:
    a tuple of G tensors (..., S). Rows are clamped to [0, M)."""
    rows = torch.clamp(rows, 0, tables[0].shape[0] - 1)
    return tuple(sample_dense_rows(t, rows, lam) for t in tables)


def sampled_y(s, wl: SampledWavelengths):
    """MC estimate of the luminance Y of a sampled spectrum."""
    ybar = sample_dense(cie_tables(wl.lam.device)[:, 1], wl.lam)
    return torch.mean(safe_div(s, wl.pdf) * ybar, dim=-1) / CIE_Y_INTEGRAL


def spectrum_to_xyz(spec, device="cuda"):
    """XYZ of a spectrum distribution by dense 1 nm quadrature."""
    v = spec(dense_lambda(device))
    return torch.sum(v[:, None] * cie_tables(device), dim=0) / CIE_Y_INTEGRAL


def spectrum_to_photometric(spec, device="cuda"):
    """Luminous output 683 * sum(y-bar * L) over the dense 1 nm grid."""
    return 683.0 * torch.sum(spec(dense_lambda(device))
                             * cie_tables(device)[:, 1])
