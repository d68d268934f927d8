"""Wavefront path tracing (``computational_ray_tracer_tpu/models/
integrator.py``): the progressive spectral render ``render()`` ->
``render_passes`` -> ``render_pass`` -> ``_path_scan`` over ``_bounce_step``.

Rays live as SoA tensors; a Python loop over bounce depth replaces the
reference's ``lax.scan``; alive masks replace early returns. Every random
decision is a pure function of (seed, pixel, sample, dim) through the
counter-based samplers, so values match the reference's for the same
inputs. Sampling decisions are detached.

The ``path`` (MIS) and ``direct`` integrators and the ``independent``,
``sobol`` and ``stratified`` samplers are ported; ``simple`` and ``walk``
and the ``sobol_global`` sampler raise until their ROADMAP items land. The
filter is ``cfg.filter_name`` (box, triangle or gaussian); the sensor is the
reference's default XYZ sensor.

``render_pass_compact`` bounces only the alive rays from depth 1 on. Every
sample is keyed by (pixel, sample, dim) and a dead ray's state no longer
changes, so its image is the full wavefront's. ``render()`` runs the full
wavefront: on the H100 each eager bounce is bound by its kernel launches,
so gathering the alive rays only adds launches and a sync
(``tools/compare_compaction.py``, PERF.md).
"""

from __future__ import annotations

import dataclasses

import torch

from computational_ray_tracer_tpu_torch.ops import rng
from computational_ray_tracer_tpu_torch.ops import spectrum as spec
from computational_ray_tracer_tpu_torch.ops import filters as flt
from computational_ray_tracer_tpu_torch.ops import sensor as sen
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops.montecarlo import power_heuristic
from computational_ray_tracer_tpu_torch.models import materials as mat
from computational_ray_tracer_tpu_torch.models import lights as lgt
from computational_ray_tracer_tpu_torch.models.scene import (
    _packet_order, scene_intersect, scene_occluded, texture_lookup)

DIM_LAMBDA = 0
DIM_FILTER = 1      # 2D
DIM_LENS = 3        # 2D
DIM_BOUNCE0 = 5
DIMS_PER_BOUNCE = 8  # bsdf 2D + bsdf 1D + light select + light pos 2D + rr


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Pixel sampler: ``sobol`` (Owen-scrambled, padded per pixel),
    ``stratified`` (an xs x ys grid, spp = xs * ys, jittered) or
    ``independent``."""
    kind: str = "independent"
    spp: int = 16
    xs: int = 4
    ys: int = 4
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("sobol", "independent", "stratified"):
            raise NotImplementedError(
                f"sampler kind {self.kind!r} is not ported yet "
                "(ROADMAP Queue 1)")

    def get_1d(self, pixel, sample_idx, dim):
        if self.kind == "stratified":
            return rng.stratified_1d(self.seed, pixel, sample_idx, dim,
                                     self.spp)
        if self.kind == "sobol":
            return rng.sobol_owen_1d(self.seed, pixel, sample_idx, dim,
                                     spp=self.spp)
        return rng.independent_1d(self.seed, pixel, sample_idx, dim)

    def get_2d(self, pixel, sample_idx, dim):
        if self.kind == "stratified":
            return rng.stratified_2d(self.seed, pixel, sample_idx, dim,
                                     self.xs, self.ys)
        if self.kind == "sobol":
            return rng.sobol_owen_2d(self.seed, pixel, sample_idx, dim,
                                     spp=self.spp)
        return rng.independent_2d(self.seed, pixel, sample_idx, dim)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    resolution: tuple = (256, 256)          # (W, H)
    sampler: SamplerConfig = SamplerConfig()
    integrator: str = "path"                # path (MIS) | direct
    max_depth: int = 5
    rr_start: int = 3                       # Russian roulette from here
    ray_eps_scale: float = 3e-5             # spawn offset / (|p| + t)
    filter_name: str = "gaussian"           # box | triangle | gaussian

    def __post_init__(self):
        if self.integrator not in ("path", "direct"):
            raise NotImplementedError(
                f"integrator {self.integrator!r} is not ported yet "
                "(ROADMAP Queue 1)")
        if self.filter_name not in flt.FILTERS:
            raise NotImplementedError(
                f"filter {self.filter_name!r} is not ported yet")


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


def _tex_coeffs(scene, si):
    if scene.texture is None:
        return None
    return texture_lookup(scene.texture, si.uv)


def li_direct(scene, o, d, wl, pixel, sample_idx, cfg):
    """Single-bounce direct lighting: front-face emission at the camera
    hit plus one light sample, f * Li * cos / pdf, behind a shadow ray.
    Camera rays that miss carry dead shadow rays."""
    si, mid = scene_intersect(scene, o, d,
                              torch.full_like(o[..., 0], float("inf")))
    mrow = mat.MaterialView.create(scene.materials, mid)
    lights = scene.lights
    n_l = lights.n_lights
    n_m = scene.materials.kind.shape[0]
    svals = _spectral_cache(scene, wl.lam)
    emit = _cache_select(svals[..., n_l:n_l + n_m], mid)
    eta_s = _cache_select(svals[..., n_l + n_m:n_l + 2 * n_m], mid)
    k_s = _cache_select(svals[..., n_l + 2 * n_m:n_l + 3 * n_m], mid)
    zero = torch.zeros_like(emit)
    L = torch.where((si.valid & ~si.backface)[..., None], emit, zero)

    s = cfg.sampler
    u_sel = s.get_1d(pixel, sample_idx, DIM_BOUNCE0)
    u_pos = s.get_2d(pixel, sample_idx, DIM_BOUNCE0 + 1)
    wi, dist, li_val, pdf, _ = lgt.sample_light(
        lights, si.p, si.n, u_sel, u_pos, svals[..., :n_l],
        scene.world_radius())
    f, _ = mat.bsdf_eval(mrow, si.n, si.wo, wi, wl.lam, (eta_s, k_s),
                         _tex_coeffs(scene, si), enable_rough=scene.has_rough)
    cos_i = torch.clamp(torch.sum(wi * si.n, dim=-1), min=0.0)
    dist = torch.where(si.valid, dist, -torch.ones_like(dist))
    occluded = scene_occluded(scene, si.p, wi, dist, spawn_eps(si, cfg),
                              si.n)
    contrib = f * li_val * (cos_i / torch.clamp(pdf, min=1e-12))[..., None]
    contrib = torch.where((si.valid & ~occluded)[..., None], contrib,
                          torch.zeros_like(contrib))
    return L + contrib


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
    """One bounce of the path/MIS wavefront: closest hit, environment and
    emission weighted against the light pdf, next-event estimation with a
    shadow ray, BSDF sampling and Russian roulette. Returns the new
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
    tex = _tex_coeffs(scene, si)

    svals = state["svals"]
    n_l = lights.n_lights
    n_m = scene.materials.kind.shape[0]
    light_vals = svals[..., :n_l]

    miss = alive & ~si.valid
    L_env = lgt.env_radiance(lights, light_vals)
    pdf_amb = lgt.pdf_ambient_direction(lights, state["n_prev"], d)
    w_env = torch.where(state["specular"], torch.ones_like(pdf_amb),
                        power_heuristic(1.0, state["pdf_prev"], 1.0, pdf_amb))
    contrib = beta * L_env * w_env[..., None]
    L = L + torch.where(miss[..., None], contrib, zero(contrib))

    # One-sided (front face) emission; the same rows give eta/k.
    emit = _cache_select(svals[..., n_l:n_l + n_m], mid)
    eta_s = _cache_select(svals[..., n_l + n_m:n_l + 2 * n_m], mid)
    k_s = _cache_select(svals[..., n_l + 2 * n_m:n_l + 3 * n_m], mid)
    emit = torch.where(si.backface[..., None], zero(emit), emit)
    pdf_l_hit = lgt.pdf_light_direction(lights, o, d, si.t)
    w_emit = torch.where(state["specular"], torch.ones_like(pdf_l_hit),
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
        lights, si.p, si.n, u_sel, u_pos, light_vals, scene.world_radius())
    f, pdf_b = mat.bsdf_eval(mrow, si.n, si.wo, wi_l, lam, (eta_s, k_s), tex,
                             enable_rough=scene.has_rough)
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
        mrow, si.n, si.wo, u2, u1, lam, (eta_s, k_s), si.backface, tex,
        enable_rough=scene.has_rough)
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
        o=torch.where(h3, o_new, o),
        d=torch.where(h3, wi, d),
        beta=torch.where(alive_new[..., None], beta_new, zero(beta_new)),
        L=L,
        alive=alive_new,
        specular=torch.where(hit, is_spec, state["specular"]),
        pdf_prev=torch.where(hit, pdf_bsdf, state["pdf_prev"]),
        n_prev=torch.where(h3, si.n, state["n_prev"]),
        lam=lam, lam_pdf=lam_pdf, svals=svals)


def _path_scan(scene, o, d, wl, pixel, sample_idx, cfg):
    """The path/MIS bounce loop over cfg.max_depth."""
    state = _init_path_state(scene, o, d, wl)
    for depth in range(cfg.max_depth):
        state = _bounce_step(scene, cfg, state, depth, pixel, sample_idx)
    return state["L"], spec.SampledWavelengths(wl.lam, state["lam_pdf"])


def make_filter(cfg: RenderConfig):
    """The config's reconstruction filter, at the radius (0.5, 0.5) of
    every workload (the reference's default)."""
    return flt.FILTERS[cfg.filter_name]((0.5, 0.5))


def camera_wavefront(camera, cfg: RenderConfig, filter_obj, sample_idx,
                     device):
    """The pass's camera wavefront: (pixel ids, wavelengths, filter weights,
    ray origins, ray directions), one ray per pixel in raster order."""
    w, h = cfg.resolution
    s = cfg.sampler
    pixel = torch.arange(w * h, dtype=torch.int64, device=device)
    px = (pixel % w).to(torch.float32)
    py = (pixel // w).to(torch.float32)
    wl = spec.sample_visible_wavelengths(s.get_1d(pixel, sample_idx,
                                                  DIM_LAMBDA))
    fp, fw = filter_obj.sample(s.get_2d(pixel, sample_idx, DIM_FILTER))
    pixel_pos = torch.stack([px + 0.5, py + 0.5], dim=-1) + fp
    o, d = camera.generate_rays(pixel_pos,
                                s.get_2d(pixel, sample_idx, DIM_LENS))
    return pixel, wl, fw, o, d


def render_pass(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                sample_idx):
    """One sample-per-pixel wavefront pass: (rgb (H, W, 3), weight (H, W))
    ready for Film.add_aligned."""
    w, h = cfg.resolution
    sample_idx = int(sample_idx)
    pixel, wl, fw, o, d = camera_wavefront(camera, cfg, filter_obj,
                                           sample_idx, scene.device)
    if cfg.integrator == "direct":
        L, wl_out = li_direct(scene, o, d, wl, pixel, sample_idx, cfg), wl
    else:
        L, wl_out = _path_scan(scene, o, d, wl, pixel, sample_idx, cfg)
    rgb = torch.clamp(sensor.to_sensor_rgb(L, wl_out), min=0.0)
    return rgb.reshape(h, w, 3), fw.reshape(h, w)


# State entries a bounce changes; lam and svals are per-ray constants.
_BOUNCE_KEYS = ("o", "d", "beta", "L", "alive", "specular", "pdf_prev",
                "n_prev", "lam_pdf")


def render_pass_compact(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                        sample_idx, alive_counts=None):
    """One path/MIS pass with between-bounce compaction: the same (rgb,
    weight) as :func:`render_pass`.

    Each bounce reads the exact alive count back (one host sync). Depth 0
    bounces the camera wavefront in launch order: a thin-lens camera's
    origins would sort into noise. From depth 1 on the alive rays are
    ordered by ``scene._packet_order`` (direction octant, Morton cell of the
    origin), gathered, bounced and scattered back, so the state stays in
    launch order and row r is pixel r when the film is assembled. A dead
    ray's state no longer changes in a bounce, so skipping it changes no
    value. ``alive_counts``, a list, receives the count at each depth."""
    if cfg.integrator == "direct":
        raise ValueError("compaction needs a multi-bounce integrator")
    w, h = cfg.resolution
    sample_idx = int(sample_idx)
    pixel, wl, fw, o, d = camera_wavefront(camera, cfg, filter_obj,
                                           sample_idx, scene.device)
    state = _init_path_state(scene, o, d, wl)
    for depth in range(cfg.max_depth):
        k = int(state["alive"].sum())                    # host sync
        if alive_counts is not None:
            alive_counts.append(k)
        if k == 0:
            break
        if depth == 0:
            state = _bounce_step(scene, cfg, state, depth, pixel, sample_idx)
            continue
        idx = _packet_order(state["o"], state["d"], state["alive"])[:k]
        sub = _bounce_step(scene, cfg, {key: v[idx] for key, v in
                                        state.items()},
                           depth, pixel[idx], sample_idx)
        for key in _BOUNCE_KEYS:          # the pass's own tensors, in place
            state[key][idx] = sub[key]
    wl_out = spec.SampledWavelengths(wl.lam, state["lam_pdf"])
    rgb = torch.clamp(sensor.to_sensor_rgb(state["L"], wl_out), min=0.0)
    return rgb.reshape(h, w, 3), fw.reshape(h, w)


def render_passes(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                  sample_idx0, n_passes: int):
    """n_passes samples per pixel accumulated as (rgb_sum, weight_sum)."""
    w, h = cfg.resolution
    rgb_sum = torch.zeros((h, w, 3), device=scene.device)
    wt_sum = torch.zeros((h, w), device=scene.device)
    for j in range(n_passes):
        rgb, wt = render_pass(scene, camera, cfg, filter_obj, sensor,
                              int(sample_idx0) + j)
        rgb_sum = rgb_sum + rgb * wt[..., None]
        wt_sum = wt_sum + wt
    return rgb_sum, wt_sum


@torch.no_grad()
def render(scene, camera, cfg: RenderConfig, film=None, progress=None,
           passes=None, chunk=1):
    """Progressive render: cfg.sampler.spp passes accumulated into a Film.
    Resume from ``film`` (continues at ``film.spp_done``); ``passes`` stops
    early; ``chunk`` passes are summed before each film update."""
    filter_obj = make_filter(cfg)
    sensor = sen.PixelSensor.create()
    if film is None:
        film = filmmod.Film.create(cfg.resolution, device=scene.device)
    start = int(film.spp_done)
    stop = cfg.sampler.spp if passes is None else min(cfg.sampler.spp,
                                                      start + passes)
    i = start
    while i < stop:
        n = min(chunk, stop - i)
        rgb_sum, wt_sum = render_passes(scene, camera, cfg, filter_obj,
                                        sensor, i, n)
        film = filmmod.Film(film.rgb_sum + rgb_sum, film.weight_sum + wt_sum,
                            film.spp_done + n)
        i += n
        if progress is not None:
            progress(i - 1, film)
    return film, sensor
