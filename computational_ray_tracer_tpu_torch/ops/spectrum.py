"""Hero-wavelength spectral core (``computational_ray_tracer_tpu/ops/
spectrum.py``): sampled wavelengths, dense-table interpolation, CIE XYZ.

A sampled spectrum is a float32 tensor with a trailing axis of 8 hero
wavelengths. Dense 1 nm tables over [360, 830] are interpolated with a
gather and a lerp. :func:`sample_dense_multi`, which every pass calls for
its spectral cache and its sensor, goes through ``ops/interp_kernel.py``:
the CUDA interpolation kernel on the card, its plain version on the CPU.
On the card it launches for every call, whatever the size (the reference
keeps its TPU kernel opt-in because inside one fused XLA program it was a
fusion barrier; in eager PyTorch one kernel replaces a chain of gathers and
lerps and breaks no fusion).
"""

from __future__ import annotations

import dataclasses

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

    def secondary_terminated(self):
        return torch.all(self.pdf[..., 1:] == 0.0, dim=-1)


def visible_wavelengths_pdf(lam):
    x = torch.cosh(0.0072 * (lam - 538.0))
    pdf = 0.0039398042 / (x * x)
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return torch.where(inside, pdf, torch.zeros_like(pdf))


def sample_visible_wavelengths(u, n=N_SPECTRUM_SAMPLES):
    """Stratified importance-sampled hero wavelengths: slot i uses
    wrap(u + i/n) through the visible inverse CDF."""
    i = torch.arange(n, dtype=u.dtype, device=u.device)
    up = u[..., None] + (i + 0.0) / n
    up = torch.where(up > 1.0, up - 1.0, up)
    lam = 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * up)
    return SampledWavelengths(lam, visible_wavelengths_pdf(lam))


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


@dataclasses.dataclass
class DenselySampledSpectrum:
    """A dense 1 nm table over [360, 830]."""
    values: torch.Tensor  # (471,)

    @classmethod
    def from_named(cls, name: str, device="cpu"):
        return cls(torch.as_tensor(data.get_named_spectrum(name),
                                   device=device))

    def __call__(self, lam):
        return sample_dense(self.values, lam)


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
