"""Analytic, tabulated, discrete and rejection samplers
(``computational_ray_tracer_tpu/ops/sampling.py``): each sampler a pure
function of explicit uniforms, elementwise over any batch shape, with its
pdf and its inverse; the alias table and the tabulated 1-D distribution
(built on the host, sampled on the tables' device); histogram checks.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)
INV_4PI = 1.0 / (4.0 * math.pi)
PI_OVER_2 = math.pi / 2.0
PI_OVER_4 = math.pi / 4.0


def _zero(x):
    return torch.zeros_like(x)


def erf_inv(x):
    """Inverse error function (polynomial approximation, ~1e-6)."""
    x = torch.clamp(x, -0.99999, 0.99999)
    w = -torch.log((1.0 - x) * (1.0 + x))

    def poly(w, p, cs):
        for c in cs:
            p = p * w + c
        return p

    small = poly(w - 2.5, 2.81022636e-08,
                 (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164,
                  0.246640727, 1.50140941))
    big = poly(torch.sqrt(w) - 3.0, -0.000200214257,
               (0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047,
                1.00167406, 2.83297682))
    return torch.where(w < 5.0, small, big) * x


# ---------------------------------------------------------------------------
# 1-D analytic samplers
# ---------------------------------------------------------------------------

def linear_pdf(x, a, b):
    """pdf proportional to lerp(x, a, b) on [0, 1]."""
    f = a + (b - a) * x
    return torch.where((x >= 0) & (x <= 1), 2.0 * f / (a + b), _zero(f))


def sample_linear(u, a, b):
    """Inverse-CDF sample of the linear pdf on [0, 1] from a to b."""
    denom = a + torch.sqrt((1.0 - u) * a * a + u * b * b)
    x = u * (a + b) / torch.where(denom == 0.0, torch.ones_like(denom),
                                  denom)
    return torch.clamp(x, max=0.9999999)


def invert_linear_sample(x, a, b):
    return x * (a * (2.0 - x) + b * x) / (a + b)


def tent_pdf(x, r):
    return torch.where(x.abs() < r, 1.0 / r - x.abs() / (r * r), _zero(x))


def sample_tent(u, r):
    """Tent on [-r, r] as two mirrored linear lobes."""
    u_left = torch.clamp(2.0 * u, 0.0, 1.0)
    u_right = torch.clamp(2.0 * u - 1.0, 0.0, 1.0)
    x_left = -r + r * sample_linear(u_left, 0.0, 1.0)
    x_right = r * sample_linear(u_right, 1.0, 0.0)
    return torch.where(u < 0.5, x_left, x_right)


def invert_tent_sample(x, r):
    return torch.where(
        x <= 0,
        invert_linear_sample(torch.clamp((x + r) / r, 0.0, 1.0), 0.0, 1.0)
        / 2.0,
        0.5 + invert_linear_sample(torch.clamp(x / r, 0.0, 1.0), 1.0, 0.0)
        / 2.0)


def exponential_pdf(x, a):
    return torch.where(x >= 0, a * torch.exp(-a * x), _zero(x))


def sample_exponential(u, a):
    """x = -ln(1 - u) / a."""
    return -torch.log1p(-u) / a


def invert_exponential_sample(x, a):
    return -torch.expm1(-a * x)


def normal_pdf(x, mu=0.0, sigma=1.0):
    return torch.exp(-0.5 * ((x - mu) / sigma) ** 2) / (
        sigma * math.sqrt(2 * math.pi))


def sample_normal(u, mu=0.0, sigma=1.0):
    """Gaussian through the inverse error function."""
    return mu + math.sqrt(2.0) * sigma * erf_inv(2.0 * u - 1.0)


def invert_normal_sample(x, mu=0.0, sigma=1.0):
    return 0.5 * (1.0 + torch.special.erf((x - mu) / (sigma * math.sqrt(2.0))))


def logistic_pdf(x, s):
    e = torch.exp(-x.abs() / s)
    return e / (s * (1.0 + e) ** 2)


def sample_logistic(u, s):
    return -s * torch.log(1.0 / u - 1.0)


def invert_logistic_sample(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


# ---------------------------------------------------------------------------
# 2-D samplers
# ---------------------------------------------------------------------------

def bilinear_pdf(p, w):
    """pdf of the bilinear interpolation of corner weights w = [w00, w10,
    w01, w11] on [0, 1]^2 (uniform where they sum to 0)."""
    x, y = p[..., 0], p[..., 1]
    s = w[..., 0] + w[..., 1] + w[..., 2] + w[..., 3]
    f = ((1 - x) * (1 - y) * w[..., 0] + x * (1 - y) * w[..., 1]
         + (1 - x) * y * w[..., 2] + x * y * w[..., 3])
    return torch.where(s > 0, 4.0 * f / s, torch.ones_like(f))


def sample_bilinear(u, w):
    """The marginal in y, then x given y, each by inversion."""
    y = sample_linear(u[..., 1], w[..., 0] + w[..., 1], w[..., 2] + w[..., 3])
    x = sample_linear(u[..., 0],
                      (1 - y) * w[..., 0] + y * w[..., 2],
                      (1 - y) * w[..., 1] + y * w[..., 3])
    return torch.stack([x, y], dim=-1)


def invert_bilinear_sample(p, w):
    px, py = p[..., 0], p[..., 1]
    y = invert_linear_sample(py, w[..., 0] + w[..., 1], w[..., 2] + w[..., 3])
    x = invert_linear_sample(px, (1 - py) * w[..., 0] + py * w[..., 2],
                             (1 - py) * w[..., 1] + py * w[..., 3])
    return torch.stack([x, y], dim=-1)


def sample_uniform_disk_polar(u, radius=1.0):
    """r = R sqrt(u1), theta = 2 pi u2."""
    r = radius * torch.sqrt(u[..., 0])
    theta = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_uniform_disk_concentric(u, radius=1.0):
    """Shirley-Chiu concentric mapping of [0,1)^2 to the disk."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0) & (y == 0)
    one = torch.ones_like(x)
    zx = torch.zeros_like(x)
    xmaj = x.abs() > y.abs()
    ratio = torch.where(
        xmaj, torch.where(x != 0, y / torch.where(x == 0, one, x), zx),
        torch.where(y != 0, x / torch.where(y == 0, one, y), zx))
    r = torch.where(xmaj, x, y)
    theta = torch.where(xmaj, PI_OVER_4 * ratio, PI_OVER_2 - PI_OVER_4 * ratio)
    p = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero[..., None], torch.zeros_like(p), radius * p)


def _phi01(w):
    """The azimuth of directions w (..., 3) as a fraction of 2 pi."""
    phi = torch.atan2(w[..., 1], w[..., 0])
    return torch.where(phi < 0, phi + 2 * math.pi, phi) * INV_2PI


def _direction(z, phi):
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_uniform_hemisphere(u):
    """Uniform direction on the z >= 0 hemisphere."""
    return _direction(u[..., 0], 2.0 * math.pi * u[..., 1])


def uniform_hemisphere_pdf():
    return INV_2PI


def invert_uniform_hemisphere_sample(w):
    return torch.stack([w[..., 2], _phi01(w)], dim=-1)


def sample_uniform_sphere(u):
    return _direction(1.0 - 2.0 * u[..., 0], 2.0 * math.pi * u[..., 1])


def uniform_sphere_pdf():
    return INV_4PI


def invert_uniform_sphere_sample(w):
    return torch.stack([(1.0 - w[..., 2]) / 2.0, _phi01(w)], dim=-1)


def sample_cosine_hemisphere(u):
    """Malley's method: the concentric disk lifted to the +z hemisphere."""
    d = sample_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_cone(u, cos_theta_max):
    """Uniform direction inside the cone of cos_theta_max around +z."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * math.pi * (1.0 - cos_theta_max))


# ---------------------------------------------------------------------------
# Discrete sampling and alias tables
# ---------------------------------------------------------------------------

def sample_discrete(u, weights):
    """Inverse CDF over unnormalized weights (..., K): (index, pmf,
    remapped u), the remapped u reusing the residual of u in the chosen
    bucket."""
    w = torch.as_tensor(weights)
    # float32 running sums, one weight at a time (torch.cumsum on the CPU
    # accumulates in float64, which rounds the CDF differently)
    cdf = torch.stack(list(itertools.accumulate(w.unbind(-1))), dim=-1)
    total = cdf[..., -1:]
    cdf = cdf / total
    up = u[..., None] if u.ndim < cdf.ndim else u
    idx = torch.clamp(torch.sum((up >= cdf).to(torch.int64), dim=-1), 0,
                      w.shape[-1] - 1)
    take = lambda t, i: torch.gather(t, -1, i[..., None])[..., 0]
    pmf = take(w / total, idx)
    lo = torch.where(idx > 0, take(cdf, torch.clamp(idx - 1, min=0)),
                     torch.zeros_like(pmf))
    hi = take(cdf, idx)
    u_remap = torch.clamp((up[..., 0] - lo) / torch.clamp(hi - lo, min=1e-12),
                          0.0, 1.0)
    return idx, pmf, u_remap


@dataclasses.dataclass(frozen=True)
class AliasTable:
    """Vose's alias method: tables built on the host, O(1) sampling."""
    q: torch.Tensor        # (K,) acceptance thresholds
    alias: torch.Tensor    # (K,) alias indices
    pmf: torch.Tensor      # (K,) normalized pmf

    @classmethod
    def build(cls, weights, device="cuda"):
        w = np.asarray(weights, dtype=np.float64)
        pmf = w / w.sum()
        k = len(w)
        q = pmf * k
        alias = np.arange(k)
        small = [i for i in range(k) if q[i] < 1.0]
        large = [i for i in range(k) if q[i] >= 1.0]
        while small and large:
            s, l = small.pop(), large.pop()
            alias[s] = l
            q[l] = (q[l] + q[s]) - 1.0
            (small if q[l] < 1.0 else large).append(l)
        t = lambda a, dt: torch.as_tensor(a.astype(dt), device=device)
        return cls(t(q, np.float32), t(alias, np.int64), t(pmf, np.float32))

    def sample(self, u):
        """(index, pmf of the index) for uniforms u."""
        k = self.q.shape[0]
        scaled = u * k
        idx = torch.clamp(scaled.to(torch.int32).to(torch.int64), 0, k - 1)
        frac = scaled - idx.to(u.dtype)
        out = torch.where(frac >= self.q[idx], self.alias[idx], idx)
        return out, self.pmf[out]


# ---------------------------------------------------------------------------
# Generic pdf utilities and tabulated inversion
# ---------------------------------------------------------------------------

def normalize_pdf(f, a, b, n=8192, device="cuda"):
    """Trapezoid-rule integral of f over [a, b] on n float32 nodes."""
    x = torch.linspace(a, b, n, device=device)
    return torch.trapezoid(f(x), x)


@dataclasses.dataclass(frozen=True)
class TabulatedDistribution1D:
    """Continuous inversion sampler of a tabulated pdf: a trapezoid CDF
    over the nodes, inverted linearly between them."""
    x: torch.Tensor      # (N,) support nodes
    pdf: torch.Tensor    # (N,) normalized density at the nodes
    cdf: torch.Tensor    # (N,)

    @classmethod
    def from_function(cls, f, a, b, n=1024, device="cuda"):
        """Tabulate f (called on float32 nodes, its values kept in
        float32) over n nodes of [a, b]."""
        x = np.linspace(a, b, n)
        fx = f(torch.as_tensor(x.astype(np.float32)))
        return cls._tabulate(x, np.maximum(np.asarray(fx), 0.0), device)

    @classmethod
    def from_table(cls, x, fx, device="cuda"):
        fx = np.maximum(np.asarray(fx, dtype=np.float64), 0.0)
        return cls._tabulate(np.asarray(x, dtype=np.float64), fx, device)

    @classmethod
    def _tabulate(cls, x, fx, device):
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (fx[1:] + fx[:-1])
                                               * np.diff(x))])
        total = cdf[-1]
        t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
        return cls(t(x), t(fx / total), t(cdf / total))

    def sample(self, u):
        """(x, pdf at x) for uniforms u."""
        i = torch.clamp(torch.searchsorted(self.cdf, u, right=True) - 1,
                        0, self.x.shape[0] - 2)
        c0, c1 = self.cdf[i], self.cdf[i + 1]
        t = (u - c0) / torch.clamp(c1 - c0, min=1e-12)
        xs = self.x[i] + t * (self.x[i + 1] - self.x[i])
        return xs, self.pdf[i] + t * (self.pdf[i + 1] - self.pdf[i])

    def pdf_at(self, xq):
        i = torch.clamp(torch.searchsorted(self.x, xq, right=True) - 1,
                        0, self.x.shape[0] - 2)
        t = (xq - self.x[i]) / torch.clamp(self.x[i + 1] - self.x[i],
                                           min=1e-12)
        return self.pdf[i] + torch.clamp(t, 0, 1) * (self.pdf[i + 1]
                                                     - self.pdf[i])


def rejection_sample_1d(f, generator, a, b, f_max, n, oversample=4):
    """Fixed-budget rejection sampling over [a, b]: oversample * n
    candidates, then n draws (with repeats) from the accepted ones, all
    from the ``torch.Generator`` (whose device is the samples')."""
    dev = generator.device
    m = oversample * n
    x = a + (b - a) * torch.rand(m, generator=generator, device=dev)
    y = f_max * torch.rand(m, generator=generator, device=dev)
    accept = y < f(x)
    accepted = x[accept]
    pick = torch.randint(0, max(accepted.shape[0], 1), (n,),
                         generator=generator, device=dev)
    return accepted[pick] if accepted.shape[0] else x[pick]


# ---------------------------------------------------------------------------
# Histogram checks
# ---------------------------------------------------------------------------

def histogram_pdf(samples, a, b, bins=64):
    """(bin centres, density) of samples over [a, b], with ``jnp.
    histogram``'s bins: right-open except the last, which holds b."""
    edges = torch.linspace(a, b, bins + 1, device=samples.device)
    i = torch.searchsorted(edges, samples, right=True)
    i = torch.where(samples == edges[-1], torch.full_like(i, bins), i)
    inside = (i >= 1) & (i <= bins)
    h = torch.bincount(i[inside] - 1, minlength=bins)
    dens = h.to(torch.float32) / (samples.shape[0] * ((b - a) / bins))
    return (edges[:-1] + edges[1:]) / 2.0, dens


def chi_square_statistic(samples, cdf, a, b, bins=32):
    """Chi-square goodness of fit of samples against an analytic CDF, over
    the bins expecting more than 5: (statistic, bins used)."""
    samples = np.asarray(samples)
    h, edges = np.histogram(samples, bins=bins, range=(a, b))
    expected = np.diff([float(cdf(e)) for e in edges]) * len(samples)
    mask = expected > 5
    return (float(np.sum((h[mask] - expected[mask]) ** 2 / expected[mask])),
            int(mask.sum()))
