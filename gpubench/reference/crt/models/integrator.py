"""Wavefront path tracing (``computational_ray_tracer_tpu/models/
integrator.py``), cut to what the benchmark's check runs: a pass
(``render_pass`` / ``_pass_for_pixels``) of the ``path`` integrator (MIS)
as ``_path_scan`` over ``_bounce_step``, and the camera wavefront
(``camera_wavefront``), with the ``sobol`` and ``stratified`` samplers,
visible hero wavelengths, the triangle and gaussian filters and the XYZ
sensor.

Rays live as SoA tensors; a Python loop over bounce depth replaces the
reference's ``lax.scan``; alive masks replace early returns. Every random
decision is a pure function of (seed, pixel, sample, dim) through the
counter-based samplers, so values match the reference's for the same
inputs, and a pixel's sample values do not depend on which pass computes
it. Sampling decisions are detached: rendering is differentiable in the
scene's material and light tables (``models/inverse.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from gpubench.reference.crt.ops import rng
from gpubench.reference.crt.ops import spectrum as spec
from gpubench.reference.crt.ops import filters as flt
from gpubench.reference.crt.ops import sensor as sen
from gpubench.reference.crt.models import materials as mat
from gpubench.reference.crt.models import lights as lgt
from gpubench.reference.precision import q as stored
from gpubench.reference.crt.models.scene import (
    scene_intersect, scene_occluded)

DIM_LAMBDA = 0
DIM_FILTER = 1      # 2D
DIM_LENS = 3        # 2D
DIM_BOUNCE0 = 5
DIMS_PER_BOUNCE = 8  # bsdf 2D + bsdf 1D + light select + light pos 2D + rr


SAMPLERS = ("stratified", "sobol")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Pixel sampler: ``sobol`` (Owen-scrambled, padded per pixel) or
    ``stratified`` (an xs x ys grid, spp = xs * ys, jittered unless
    ``jitter`` is off)."""
    kind: str = "sobol"
    spp: int = 16
    xs: int = 4
    ys: int = 4
    seed: int = 0
    jitter: bool = True

    def __post_init__(self):
        if self.kind not in SAMPLERS:
            raise ValueError(f"unknown sampler kind {self.kind!r}")

    def get_1d(self, pixel, sample_idx, dim):
        if self.kind == "stratified":
            return rng.stratified_1d(self.seed, pixel, sample_idx, dim,
                                     self.spp, self.jitter)
        return rng.sobol_owen_1d(self.seed, pixel, sample_idx, dim,
                                 spp=self.spp)

    def get_2d(self, pixel, sample_idx, dim):
        if self.kind == "stratified":
            return rng.stratified_2d(self.seed, pixel, sample_idx, dim,
                                     self.xs, self.ys, self.jitter)
        return rng.sobol_owen_2d(self.seed, pixel, sample_idx, dim,
                                 spp=self.spp)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    resolution: tuple = (256, 256)          # (W, H)
    sampler: SamplerConfig = SamplerConfig()
    # path (MIS); direct is the canonical frame's, whose Li is
    # gpubench/reference/passes.py's canonical_film.
    integrator: str = "path"
    max_depth: int = 5
    rr_start: int = 3                       # Russian roulette from here
    ray_eps_scale: float = 3e-5             # spawn offset / (|p| + t)
    filter_name: str = "gaussian"           # triangle | gaussian
    filter_radius: tuple = (0.5, 0.5)
    clamp: float = 0.0                      # 0: no firefly clamp

    def __post_init__(self):
        if self.integrator not in ("path", "direct"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.filter_name not in flt.FILTERS:
            raise ValueError(f"unknown filter {self.filter_name!r}")


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (beta = 2), as ``ops/montecarlo.py`` has it."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-30)


def spawn_eps(si, cfg: RenderConfig):
    """Scale-relative self-intersection offset: ray_eps_scale * (|p| + t)."""
    t = torch.where(torch.isfinite(si.t), si.t, torch.zeros_like(si.t))
    mag = si.p.abs().amax(-1) + t.abs()
    return cfg.ray_eps_scale * torch.clamp(mag, min=1e-3)


def _spectral_cache(scene, lam):
    """Every dense table at the hero wavelengths, once per pass:
    (..., S, L + 3M) ordered [lights.spd | emission | eta | k]."""
    stack = torch.cat([scene.lights.spd, scene.materials.emission,
                       scene.materials.eta, scene.materials.k], dim=0)
    return spec.sample_dense_multi(stack.T, lam)


def _cache_select(vals, idx):
    """vals (..., S, M), idx (...) -> (..., S): a gather over the trailing
    axis (out-of-range idx clamps; callers mask)."""
    idx = torch.clamp(idx, 0, vals.shape[-1] - 1)
    return torch.gather(vals, -1, idx[..., None, None].expand(
        vals.shape[:-1] + (1,)))[..., 0]


def _init_path_state(scene, o, d, wl):
    n_shape = o.shape[:-1]
    S = wl.lam.shape[-1]
    dev = o.device
    return dict(
        o=o, d=d,
        beta=torch.ones(n_shape + (S,), device=dev),
        L=torch.zeros(n_shape + (S,), device=dev),
        alive=torch.ones(n_shape, dtype=torch.bool, device=dev),
        specular=torch.ones(n_shape, dtype=torch.bool, device=dev),
        pdf_prev=torch.ones(n_shape, device=dev),
        n_prev=torch.zeros(n_shape + (3,), device=dev),
        lam=wl.lam, lam_pdf=wl.pdf,
        svals=_spectral_cache(scene, wl.lam))


def _bounce_step(scene, cfg, state, depth, pixel, sample_idx):
    """One bounce of the wavefront: closest hit; environment and emission
    weighted against the light pdf (MIS); next-event estimation with a
    shadow ray; BSDF sampling and Russian roulette. Returns the new
    state."""
    s = cfg.sampler
    o, d = state["o"], state["d"]
    alive = state["alive"]
    beta = state["beta"]
    L = state["L"]
    lam = state["lam"]
    S = lam.shape[-1]
    lights = scene.lights
    zero = lambda x: torch.zeros_like(x)

    t_max = torch.where(alive, torch.full_like(o[..., 0], float("inf")),
                        torch.full_like(o[..., 0], -1.0))
    si, mid = scene_intersect(scene, o, d, t_max)
    hit = si.valid & alive
    mrow = mat.MaterialView.create(scene.materials, mid)

    svals = state["svals"]
    n_l = lights.n_lights
    n_m = scene.materials.kind.shape[0]
    light_vals = svals[..., :n_l]

    miss = alive & ~si.valid
    L_env, _ = lgt.env_radiance(lights, light_vals)
    one = torch.ones_like(state["pdf_prev"])
    pdf_amb = lgt.pdf_ambient_direction(lights, state["n_prev"], d)
    w_env = torch.where(state["specular"], one,
                        power_heuristic(1.0, state["pdf_prev"], 1.0, pdf_amb))
    contrib = beta * L_env * w_env[..., None]
    L = L + torch.where(miss[..., None], contrib, zero(contrib))

    # One-sided (front face) emission; the same rows give eta/k.
    emit = _cache_select(svals[..., n_l:n_l + n_m], mid)
    eta_s = _cache_select(svals[..., n_l + n_m:n_l + 2 * n_m], mid)
    k_s = _cache_select(svals[..., n_l + 2 * n_m:n_l + 3 * n_m], mid)
    emit = torch.where(si.backface[..., None], zero(emit), emit)
    pdf_l_hit = lgt.pdf_light_direction(lights, o, d, si.t)
    w_emit = torch.where(state["specular"], one,
                         power_heuristic(1.0, state["pdf_prev"], 1.0,
                                         pdf_l_hit))
    contrib = beta * emit * w_emit[..., None]
    L = L + torch.where(hit[..., None], contrib, zero(contrib))

    dim0 = DIM_BOUNCE0 + depth * DIMS_PER_BOUNCE
    eps_h = spawn_eps(si, cfg)

    # next-event estimation; rays without a hit carry dead shadow rays
    u_sel = s.get_1d(pixel, sample_idx, dim0 + 3)
    u_pos = s.get_2d(pixel, sample_idx, dim0 + 4)
    wi_l, dist, li_val, pdf_l, lkind = lgt.sample_light(
        lights, si.p, si.n, lam, u_sel, u_pos, scene.world_radius(),
        spd_vals=light_vals)
    f, pdf_b = mat.bsdf_eval(mrow, si.n, si.wo, wi_l, lam)
    cos_l = torch.clamp(torch.sum(wi_l * si.n, dim=-1), min=0.0)
    occ = scene_occluded(scene, si.p, wi_l,
                         torch.where(hit, dist, -torch.ones_like(dist)),
                         eps_h, si.n)
    nee = beta * f * li_val * (cos_l / torch.clamp(pdf_l, min=1e-12)
                               )[..., None]
    # delta lights (point/distant) cannot be BSDF-sampled: weight 1
    hittable = (lkind == lgt.AREA_QUAD) | (lkind == lgt.AMBIENT)
    w_l = torch.where(hittable, power_heuristic(1.0, pdf_l, 1.0, pdf_b),
                      torch.ones_like(pdf_l))
    nee = nee * w_l[..., None]
    L = L + torch.where((hit & ~occ)[..., None], nee, zero(nee))

    u2 = s.get_2d(pixel, sample_idx, dim0)
    u1 = s.get_1d(pixel, sample_idx, dim0 + 2)
    wi, w_bsdf, pdf_bsdf, is_spec, term_2nd = mat.bsdf_sample(
        mrow, si.n, si.wo, u2, u1, lam, eta_k=(eta_s, k_s),
        backface=si.backface)
    beta_new = beta * w_bsdf
    # dispersion: collapse secondary wavelengths at dielectric bounces
    lam_pdf = state["lam_pdf"]
    done = spec.SampledWavelengths(lam, lam_pdf).secondary_terminated()
    collapse = (hit & term_2nd & ~done)[..., None]
    lam_pdf = torch.where(collapse, torch.cat(
        [lam_pdf[..., :1] / S, zero(lam_pdf[..., 1:])], -1), lam_pdf)
    beta_new = torch.where(collapse, torch.cat(
        [beta_new[..., :1], zero(beta_new[..., 1:])], -1), beta_new)

    # Russian roulette (detached)
    max_beta = beta_new.detach().amax(-1)
    survive = torch.ones_like(hit)
    if depth >= cfg.rr_start:
        u_rr = s.get_1d(pixel, sample_idx, dim0 + 6)
        q = torch.clamp(max_beta, 0.05, 1.0)
        survive = u_rr < q
        beta_new = beta_new / q[..., None]

    alive_new = hit & survive & (max_beta > 0.0)
    side = torch.sign(torch.sum(wi * si.n, dim=-1))
    o_new = si.p + si.n * (side * eps_h)[..., None]
    h3 = hit[..., None]
    return dict(
        o=stored(torch.where(h3, o_new, o)),
        d=stored(torch.where(h3, wi, d)),
        beta=stored(torch.where(alive_new[..., None], beta_new,
                                zero(beta_new))),
        L=stored(L),
        alive=alive_new,
        specular=torch.where(hit, is_spec, state["specular"]),
        pdf_prev=torch.where(hit, pdf_bsdf, state["pdf_prev"]),
        n_prev=torch.where(h3, si.n, state["n_prev"]),
        lam=lam, lam_pdf=lam_pdf, svals=svals)


def _path_scan(scene, o, d, wl, pixel, sample_idx, cfg):
    """The bounce loop over cfg.max_depth: (L, wavelengths)."""
    state = _init_path_state(scene, o, d, wl)
    for depth in range(cfg.max_depth):
        state = _bounce_step(scene, cfg, state, depth, pixel, sample_idx)
    return state["L"], spec.SampledWavelengths(wl.lam, state["lam_pdf"])


def make_filter(cfg: RenderConfig):
    """The config's reconstruction filter at ``cfg.filter_radius``."""
    return flt.FILTERS[cfg.filter_name](tuple(cfg.filter_radius))


def make_sensor(cfg: RenderConfig):
    """The config's pixel sensor: the XYZ sensor."""
    return sen.PixelSensor.create()


def _sensor_rgb(cfg: RenderConfig, sensor, L, wl):
    """Sensor RGB of the pass, clamped to [0, cfg.clamp] (the firefly
    clamp) or at 0 from below. ``maximum``/``minimum`` and not ``clamp``:
    at a tie they pass half the gradient, as the reference's
    ``jnp.maximum``/``jnp.clip`` do (a sample whose radiance is exactly 0,
    e.g. a camera ray on the ceiling beside the light, sits at the tie)."""
    rgb = stored(sensor.to_sensor_rgb(stored(L), wl))
    rgb = torch.maximum(rgb, rgb.new_zeros(()))
    if cfg.clamp > 0.0:
        rgb = torch.minimum(rgb, rgb.new_full((), cfg.clamp))
    return rgb


def camera_wavefront(camera, cfg: RenderConfig, filter_obj, sample_idx,
                     device, pixel=None):
    """The pass's camera wavefront: (pixel ids, wavelengths, filter weights,
    ray origins, ray directions), one ray per pixel of ``pixel`` (flat
    int64 ids; default every pixel in raster order)."""
    w, h = cfg.resolution
    s = cfg.sampler
    if pixel is None:
        pixel = torch.arange(w * h, dtype=torch.int64, device=device)
    px = (pixel % w).to(torch.float32)
    py = (pixel // w).to(torch.float32)
    wl = spec.sample_visible_wavelengths(
        s.get_1d(pixel, sample_idx, DIM_LAMBDA))
    fp, fw = filter_obj.sample(s.get_2d(pixel, sample_idx, DIM_FILTER))
    pixel_pos = torch.stack([px + 0.5, py + 0.5], dim=-1) + fp
    o, d = camera.generate_rays(pixel_pos,
                                s.get_2d(pixel, sample_idx, DIM_LENS))
    return pixel, wl, stored(fw), stored(o), stored(d)


def _pass_for_pixels(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                     pixel, sample_idx):
    """One sample for each flat pixel id of ``pixel`` (None: every pixel):
    (sensor rgb (n, 3), filter weight (n,)) at the int ``sample_idx``."""
    pixel, wl, fw, o, d = camera_wavefront(camera, cfg, filter_obj,
                                           sample_idx, scene.device, pixel)
    if cfg.integrator != "path":
        raise ValueError(f"no pass of the {cfg.integrator!r} integrator")
    L, wl_out = _path_scan(scene, o, d, wl, pixel, sample_idx, cfg)
    return _sensor_rgb(cfg, sensor, L, wl_out), fw


def render_pass(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                sample_idx):
    """One sample-per-pixel wavefront pass at the int ``sample_idx``:
    (rgb (H, W, 3), weight (H, W))."""
    w, h = cfg.resolution
    rgb, fw = _pass_for_pixels(scene, camera, cfg, filter_obj, sensor, None,
                               sample_idx)
    return rgb.reshape(h, w, 3), fw.reshape(h, w)
