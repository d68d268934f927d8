"""Lights with next-event sampling (``computational_ray_tracer_tpu/models/
lights.py``): point, distant, one-sided quad area and ambient lights in one
SoA table; every per-kind quantity is computed and selected branch-free."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import color as colorlib
from computational_ray_tracer_tpu_torch.ops import spectra_data as data
from computational_ray_tracer_tpu_torch.ops import sampling as smp
from computational_ray_tracer_tpu_torch.models.materials import (build_frame,
                                                                 to_world)

POINT = 0
DISTANT = 1
AREA_QUAD = 2
AMBIENT = 3

FIELDS = ("kind", "position", "direction", "edge1", "edge2", "spd", "scale")


@dataclasses.dataclass
class LightTable:
    kind: torch.Tensor       # (L,) int64
    position: torch.Tensor   # (L, 3) point position / quad corner
    direction: torch.Tensor  # (L, 3) distant direction (pointing FROM light)
    edge1: torch.Tensor      # (L, 3)
    edge2: torch.Tensor      # (L, 3)
    spd: torch.Tensor        # (L, 471)
    scale: torch.Tensor      # (L,)

    @property
    def n_lights(self):
        return self.kind.shape[0]

    @classmethod
    def from_arrays(cls, arrays, device="cpu"):
        """From the reference table's 7 leaves as numpy arrays."""
        f = lambda n: torch.tensor(np.asarray(arrays[n], np.float32),
                                   device=device)
        return cls(torch.tensor(np.asarray(arrays["kind"], np.int64),
                                device=device),
                   f("position"), f("direction"), f("edge1"), f("edge2"),
                   f("spd"), f("scale"))

    @classmethod
    def build(cls, lights, device="cpu"):
        kind_map = {"point": POINT, "distant": DISTANT, "quad": AREA_QUAD,
                    "ambient": AMBIENT}
        n = len(lights)
        out = {"kind": np.zeros(n, np.int64),
               "position": np.zeros((n, 3), np.float32),
               "direction": np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32),
                                    (n, 1)),
               "edge1": np.zeros((n, 3), np.float32),
               "edge2": np.zeros((n, 3), np.float32),
               "spd": np.zeros((n, 471), np.float32),
               "scale": np.ones(n, np.float32)}
        lam = torch.as_tensor(data.DENSE_LAMBDA.astype(np.float32))
        for i, l in enumerate(lights):
            out["kind"][i] = kind_map[l["kind"]]
            out["scale"][i] = float(l.get("scale", 1.0))
            if "spd_named" in l:
                out["spd"][i] = data.get_named_spectrum(l["spd_named"])
            elif "spd_dense" in l:
                out["spd"][i] = np.asarray(l["spd_dense"], np.float32)
            elif "rgb" in l:
                out["spd"][i] = colorlib.RGBIlluminantSpectrum.from_rgb(
                    l["rgb"])(lam).numpy()
            else:
                out["spd"][i] = data.ILLUM_E
            if "position" in l:
                out["position"][i] = np.asarray(l["position"], np.float32)
            if "corner" in l:
                out["position"][i] = np.asarray(l["corner"], np.float32)
            if "direction" in l:
                dd = np.asarray(l["direction"], np.float64)
                out["direction"][i] = dd / np.linalg.norm(dd)
            if "edge1" in l:
                out["edge1"][i] = np.asarray(l["edge1"], np.float32)
                out["edge2"][i] = np.asarray(l["edge2"], np.float32)
        return cls.from_arrays(out, device)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def sample_light(table: LightTable, p, n, u_light, u_pos, spd_vals,
                 world_radius=100.0):
    """Next-event sample toward one uniformly chosen light per point.
    ``spd_vals`` (..., S, L): the light SPDs at the hero wavelengths (the
    integrator's per-pass spectral cache). Returns (wi, dist, Li (..., S),
    pdf, kind); pdf includes the 1/n_lights selection factor."""
    nl = table.n_lights
    li = torch.clamp((u_light.detach() * nl).to(torch.int64), 0, nl - 1)
    kind = table.kind[li]
    pos_l = table.position[li]
    dir_l = table.direction[li]
    e1_l = table.edge1[li]
    e2_l = table.edge2[li]
    spd_interp = torch.gather(
        spd_vals, -1, li[..., None, None].expand(spd_vals.shape[:-1] + (1,))
    )[..., 0]
    spd_at = spd_interp * table.scale[li][..., None]

    # point
    to_l = pos_l - p
    dist2 = torch.clamp(_dot(to_l, to_l), min=1e-12)
    dist_point = torch.sqrt(dist2)
    wi_point = to_l / dist_point[..., None]
    li_point = spd_at / dist2[..., None]
    # distant
    wi_dist = -dir_l
    # quad: uniform point on the parallelogram, one-sided
    qp = pos_l + u_pos[..., 0:1] * e1_l + u_pos[..., 1:2] * e2_l
    qn = torch.linalg.cross(e1_l, e2_l)
    area = torch.clamp(torch.linalg.norm(qn, dim=-1), min=1e-12)
    qn = qn / area[..., None]
    to_q = qp - p
    dq2 = torch.clamp(_dot(to_q, to_q), min=1e-12)
    dq = torch.sqrt(dq2)
    wi_quad = to_q / dq[..., None]
    cos_l = _dot(-wi_quad, qn)
    pdf_quad = dq2 / torch.clamp(area * cos_l.abs(), min=1e-12)
    li_quad = torch.where((cos_l > 0)[..., None], spd_at,
                          torch.zeros_like(spd_at))
    # ambient: cosine-weighted
    t_, b_ = build_frame(n)
    wi_amb = to_world(t_, b_, n, smp.sample_cosine_hemisphere(u_pos))
    pdf_amb = torch.clamp(_dot(wi_amb, n), min=1e-9) / math.pi

    def sel(v0, v1, v2, v3):
        k = kind[..., None] if v0.ndim > kind.ndim else kind
        return torch.where(k == POINT, v0, torch.where(
            k == DISTANT, v1, torch.where(k == AREA_QUAD, v2, v3)))

    far = torch.full_like(dist_point, world_radius)
    one = torch.ones_like(dist_point)
    wi = sel(wi_point, wi_dist, wi_quad, wi_amb)
    dist = sel(dist_point, far, dq, far)
    li_val = sel(li_point, spd_at, li_quad, spd_at)
    pdf = sel(one, one, pdf_quad, pdf_amb) / nl
    return wi, dist, li_val, pdf, kind


def env_radiance(table: LightTable, spd_vals):
    """Radiance an escaped ray collects from ambient lights: Σ spd·scale,
    from the light SPDs at the hero wavelengths ``spd_vals`` (..., S, L)."""
    w = torch.where(table.kind == AMBIENT, table.scale,
                    torch.zeros_like(table.scale))
    return torch.einsum("...sl,l->...s", spd_vals, w)


def pdf_ambient_direction(table: LightTable, n_prev, d):
    """Solid-angle pdf that NEE at normal ``n_prev`` produced the escaped
    direction ``d`` through an ambient light."""
    n_amb = (table.kind == AMBIENT).sum().to(torch.float32)
    cos = torch.clamp(_dot(n_prev, d), min=0.0)
    return (n_amb / table.n_lights) * cos / math.pi


def pdf_light_direction(table: LightTable, p, d, t_hit, rel_tol=1e-2):
    """Solid-angle pdf that NEE from ``p`` would have produced direction
    ``d`` whose surface hit lies at ``t_hit`` (quad lights only; summed over
    matching lights, with the 1/n_lights selection factor)."""
    pe = p[..., None, :]
    de = d[..., None, :]
    corner, e1, e2 = table.position, table.edge1, table.edge2
    qn = torch.linalg.cross(e1, e2)
    area = torch.clamp(torch.linalg.norm(qn, dim=-1), min=1e-12)
    qn_u = qn / area[..., None]
    denom = _dot(de, qn_u)
    safe = torch.where(denom.abs() < 1e-9, torch.ones_like(denom), denom)
    t_q = _dot(corner - pe, qn_u) / safe
    rel = pe + de * t_q[..., None] - corner
    g11, g12, g22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
    det = torch.clamp(g11 * g22 - g12 * g12, min=1e-20)
    r1, r2 = _dot(rel, e1), _dot(rel, e2)
    a = (g22 * r1 - g12 * r2) / det
    b = (g11 * r2 - g12 * r1) / det
    cos_l = _dot(-de, qn_u)
    th = t_hit[..., None]
    ok = ((table.kind == AREA_QUAD) & (denom.abs() >= 1e-9) & (t_q > 0.0)
          & (a >= -1e-4) & (a <= 1.0 + 1e-4) & (b >= -1e-4)
          & (b <= 1.0 + 1e-4) & (cos_l > 1e-6)
          & ((t_q - th).abs() <= rel_tol * torch.clamp(th, min=1e-6)))
    pdf_quad = t_q ** 2 / torch.clamp(area * cos_l.abs(), min=1e-12)
    return torch.where(ok, pdf_quad, torch.zeros_like(pdf_quad)).sum(-1) \
        / table.n_lights
