"""Materials and BSDFs (``computational_ray_tracer_tpu/models/
materials.py``): an SoA material table, per-ray views, and branch-free
evaluation/sampling of all four kinds (the wavefront evaluates every kind's
branch and selects).

Kinds: 0 Lambertian, 1 smooth conductor, 2 smooth dielectric, 3 rough
(GGX) conductor.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import color as colorlib
from computational_ray_tracer_tpu_torch.ops import spectrum as spec
from computational_ray_tracer_tpu_torch.ops import spectra_data as data
from computational_ray_tracer_tpu_torch.ops import sampling as smp

LAMBERTIAN = 0
CONDUCTOR = 1
DIELECTRIC = 2
ROUGH_CONDUCTOR = 3

INV_PI = 1.0 / math.pi

FIELDS = ("kind", "albedo_coeffs", "emission", "eta", "k", "use_texture",
          "roughness")


@dataclasses.dataclass
class MaterialTable:
    kind: torch.Tensor           # (M,) int64
    albedo_coeffs: torch.Tensor  # (M, 3) sigmoid-polynomial coefficients
    emission: torch.Tensor       # (M, 471) dense emitted radiance
    eta: torch.Tensor            # (M, 471) dense IoR
    k: torch.Tensor              # (M, 471) dense extinction
    use_texture: torch.Tensor    # (M,) bool
    roughness: torch.Tensor      # (M,) GGX alpha

    @classmethod
    def from_arrays(cls, arrays, device="cpu"):
        """From the reference table's 7 leaves as numpy arrays."""
        kind = torch.tensor(np.asarray(arrays["kind"], np.int64),
                            device=device)
        tex = torch.tensor(np.asarray(arrays["use_texture"], bool),
                           device=device)
        f = lambda n: torch.tensor(np.asarray(arrays[n], np.float32),
                                   device=device)
        return cls(kind, f("albedo_coeffs"), f("emission"), f("eta"), f("k"),
                   tex, f("roughness"))

    @classmethod
    def build(cls, mats, device="cpu"):
        """mats: list of dicts (kind, albedo_rgb, emission_rgb +
        emission_scale or emission_dense, metal, glass, eta, roughness,
        use_texture), as the reference's ``MaterialTable.build``."""
        kind_map = {"diffuse": LAMBERTIAN, "conductor": CONDUCTOR,
                    "dielectric": DIELECTRIC,
                    "rough_conductor": ROUGH_CONDUCTOR}
        n = len(mats)
        out = {"kind": np.zeros(n, np.int64),
               "emission": np.zeros((n, 471), np.float32),
               "eta": np.full((n, 471), 1.5, np.float32),
               "k": np.zeros((n, 471), np.float32),
               "use_texture": np.zeros(n, bool),
               "roughness": np.full(n, 0.1, np.float32)}
        rgbs = []
        lam = torch.as_tensor(data.DENSE_LAMBDA.astype(np.float32))
        for i, m in enumerate(mats):
            out["kind"][i] = kind_map[m.get("kind", "diffuse")]
            out["roughness"][i] = float(m.get("roughness", 0.1))
            rgbs.append(m.get("albedo_rgb", (0.5, 0.5, 0.5)))
            if "emission_dense" in m:
                out["emission"][i] = np.asarray(m["emission_dense"], np.float32)
            elif "emission_rgb" in m:
                e = colorlib.RGBIlluminantSpectrum.from_rgb(m["emission_rgb"])
                out["emission"][i] = e(lam).numpy() * m.get(
                    "emission_scale", 1.0)
            if "metal" in m:
                out["eta"][i] = data.METAL_ETA[m["metal"]]
                out["k"][i] = data.METAL_K[m["metal"]]
            elif "glass" in m:
                out["eta"][i] = data.GLASS_IOR[m["glass"]]
            elif "eta" in m:
                out["eta"][i] = float(m["eta"])
            out["use_texture"][i] = bool(m.get("use_texture", False))
        out["albedo_coeffs"] = colorlib.fit_rgb_to_spectrum(
            np.asarray(rgbs, np.float32)).numpy()
        return cls.from_arrays(out, device)


@dataclasses.dataclass
class MaterialView:
    """Per-ray material rows: small fields gathered, dense tables left in
    place with the row index."""
    kind: torch.Tensor
    albedo_coeffs: torch.Tensor
    use_texture: torch.Tensor
    roughness: torch.Tensor
    table: MaterialTable
    mid: torch.Tensor

    @classmethod
    def create(cls, table: MaterialTable, mid):
        m = table.kind.shape[0]
        mid = torch.clamp(mid, 0, m - 1)
        return cls(table.kind[mid], table.albedo_coeffs[mid],
                   table.use_texture[mid], table.roughness[mid], table, mid)


def material_spectra(view: MaterialView, lam):
    """(emission, eta, k) at the hero wavelengths."""
    t = view.table
    return tuple(spec.sample_dense_rows(x, view.mid, lam)
                 for x in (t.emission, t.eta, t.k))


def material_albedo(view, lam, tex_rgb_coeffs=None):
    alb = colorlib.sigmoid_polynomial(view.albedo_coeffs, lam)
    if tex_rgb_coeffs is not None:
        tex = colorlib.sigmoid_polynomial(tex_rgb_coeffs, lam)
        alb = torch.where(view.use_texture[..., None], alb * tex, alb)
    return alb


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def build_frame(n):
    """Orthonormal tangents (t, b) for normals n (Duff et al.)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    t2 = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t1, t2


def to_local(t, b, n, w):
    return torch.stack([_dot(w, t), _dot(w, b), _dot(w, n)], dim=-1)


def to_world(t, b, n, w):
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


def reflect(w, n):
    return -w + 2.0 * _dot(w, n)[..., None] * n


def refract(wi, n, eta_rel):
    cos_i = _dot(wi, n)
    sin2_t = torch.clamp(1.0 - cos_i ** 2, min=0.0) / (eta_rel ** 2)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -wi / eta_rel[..., None] + (cos_i / eta_rel - cos_t)[..., None] * n
    return wt, sin2_t >= 1.0


def fresnel_dielectric(cos_i, eta):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = torch.clamp(1.0 - cos_i ** 2, min=0.0) / (eta ** 2)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-9)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-9)
    f = 0.5 * (r_par ** 2 + r_perp ** 2)
    return torch.where(sin2_t >= 1.0, torch.ones_like(f), f)


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel with complex IoR eta - i k."""
    cos_i = torch.clamp(cos_i, 1e-5, 1.0)
    cos2 = cos_i ** 2
    sin2 = 1.0 - cos2
    t0 = eta ** 2 + k ** 2 - sin2
    a2b2 = torch.sqrt(torch.clamp(t0 ** 2 + 4.0 * eta ** 2 * k ** 2, min=0.0))
    t1 = a2b2 + cos2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * cos_i
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-9)
    t3 = cos2 * a2b2 + sin2 ** 2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-9)
    return 0.5 * (rs + rp)


def ggx_d(cos_h, alpha):
    a2 = alpha * alpha
    denom = cos_h * cos_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * denom * denom, min=1e-12)


def ggx_g1(cos_v, alpha):
    a2 = alpha * alpha
    c = torch.clamp(cos_v, 1e-5, 1.0)
    return 2.0 * c / torch.clamp(c + torch.sqrt(a2 + (1.0 - a2) * c * c),
                                 min=1e-12)


def ggx_sample_half(u2, alpha):
    a2 = alpha * alpha
    cos_h = torch.sqrt(torch.clamp((1.0 - u2[..., 0])
                                   / (1.0 + (a2 - 1.0) * u2[..., 0]), 0.0, 1.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    return torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h],
                       dim=-1)


def _rough_conductor_fpdf(wo_l, wi_l, alpha, eta_s, k_s, tint):
    cos_o = wo_l[..., 2]
    cos_i = wi_l[..., 2]
    same = (cos_o > 1e-5) & (cos_i > 1e-5)
    h = wo_l + wi_l
    h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True), min=1e-12)
    cos_h = torch.clamp(h[..., 2], 0.0, 1.0)
    odoth = torch.clamp(_dot(wo_l, h), min=1e-6)
    d_val = ggx_d(cos_h, alpha)
    g = ggx_g1(cos_o, alpha) * ggx_g1(cos_i, alpha)
    fr = fresnel_conductor(odoth[..., None], eta_s, k_s) * tint
    f = fr * (d_val * g / torch.clamp(4.0 * cos_o * cos_i, min=1e-6))[..., None]
    pdf = d_val * cos_h / (4.0 * odoth)
    return (torch.where(same[..., None], f, torch.zeros_like(f)),
            torch.where(same, pdf, torch.zeros_like(pdf)))


def bsdf_eval(view, n, wo, wi, lam, eta_k, tex_rgb_coeffs=None,
              enable_rough=True):
    """f(wo, wi) (..., S) and pdf(wi) of the sampleable lobes (Lambertian +
    GGX); delta kinds evaluate to 0. ``eta_k``: the (eta, k) spectra at
    the hero wavelengths (``material_spectra`` or the spectral cache)."""
    cos_i = _dot(n, wi)
    same_hemi = (_dot(n, wo) > 0) & (cos_i > 0)
    alb = material_albedo(view, lam, tex_rgb_coeffs)
    is_diffuse = (view.kind == LAMBERTIAN) & same_hemi
    f = torch.where(is_diffuse[..., None], alb * INV_PI, torch.zeros_like(alb))
    pdf = torch.where(is_diffuse, torch.clamp(cos_i, min=0.0) * INV_PI,
                      torch.zeros_like(cos_i))
    if enable_rough:
        is_rough = view.kind == ROUGH_CONDUCTOR
        t, b = build_frame(n)
        eta_s, k_s = eta_k
        tint = colorlib.sigmoid_polynomial(view.albedo_coeffs, lam)
        f_r, pdf_r = _rough_conductor_fpdf(to_local(t, b, n, wo),
                                           to_local(t, b, n, wi),
                                           view.roughness, eta_s, k_s, tint)
        f = torch.where(is_rough[..., None], f_r, f)
        pdf = torch.where(is_rough, pdf_r, pdf)
    return f, pdf


def bsdf_sample(view, n, wo, u2, u1, lam, eta_k, backface,
                tex_rgb_coeffs=None, enable_rough=True):
    """Sample an outgoing direction per hit: (wi, weight (..., S), pdf,
    is_specular, terminate_secondary); weight = f·|cos|/pdf. ``backface``
    (the ray hit the geometric back side) picks the dielectric's eta."""
    u2 = u2.detach()
    u1 = u1.detach()
    t, b = build_frame(n)
    wo_l = to_local(t, b, n, wo)
    kind = view.kind

    wi_l_diff = smp.sample_cosine_hemisphere(u2)
    wi_diff = to_world(t, b, n, wi_l_diff)
    w_diff = material_albedo(view, lam, tex_rgb_coeffs)
    pdf_diff = torch.clamp(wi_l_diff[..., 2], min=1e-9) * INV_PI

    wi_spec = reflect(wo, n)
    cos_i = _dot(n, wo).abs()
    eta_s, k_s = eta_k
    tint = colorlib.sigmoid_polynomial(view.albedo_coeffs, lam)
    w_cond = fresnel_conductor(cos_i[..., None], eta_s, k_s) * tint

    if enable_rough:
        h_l = ggx_sample_half(u2, view.roughness)
        wi_l_rough = 2.0 * _dot(wo_l, h_l)[..., None] * h_l - wo_l
        wi_rough = to_world(t, b, n, wi_l_rough)
        f_rough, pdf_rough = _rough_conductor_fpdf(
            wo_l, wi_l_rough, view.roughness, eta_s, k_s, tint)
        w_rough = f_rough * (torch.clamp(wi_l_rough[..., 2], min=0.0)
                             / torch.clamp(pdf_rough, min=1e-12))[..., None]
        w_rough = torch.where((pdf_rough > 1e-12)[..., None], w_rough,
                              torch.zeros_like(w_rough))
    else:
        wi_rough, w_rough = wi_spec, w_cond
        pdf_rough = torch.ones_like(cos_i)

    eta_hero = eta_s[..., 0]
    eta_rel = torch.where(~backface, eta_hero, 1.0 / eta_hero)
    fr = fresnel_dielectric(cos_i, eta_rel)
    refl = u1 < fr
    wt, tir = refract(wo, n, eta_rel)
    wt = wt / torch.clamp(torch.linalg.norm(wt, dim=-1, keepdim=True),
                          min=1e-9)
    refl = (refl | tir)[..., None]
    wi_diel = torch.where(refl, wi_spec, wt)
    w_diel = torch.where(refl, torch.ones_like(lam),
                         (1.0 / eta_rel ** 2)[..., None].expand_as(lam))

    def pick(v_diff, v_cond, v_rough, v_diel):
        k = kind[..., None] if v_diff.ndim > kind.ndim else kind
        return torch.where(k == LAMBERTIAN, v_diff, torch.where(
            k == CONDUCTOR, v_cond, torch.where(k == ROUGH_CONDUCTOR,
                                                v_rough, v_diel)))

    wi = pick(wi_diff, wi_spec, wi_rough, wi_diel)
    weight = pick(w_diff, w_cond, w_rough, w_diel)
    one = torch.ones_like(pdf_diff)
    pdf = pick(pdf_diff, one, pdf_rough, one)
    is_spec = (kind == CONDUCTOR) | (kind == DIELECTRIC)
    return wi, weight, pdf, is_spec, kind == DIELECTRIC
