"""Wavefront path tracing (``computational_ray_tracer_tpu/models/
integrator.py``): the progressive spectral render ``render()`` ->
``render_passes`` -> ``render_pass`` -> ``_path_scan`` over ``_bounce_step``.

Rays live as SoA tensors; a Python loop over bounce depth replaces the
reference's ``lax.scan``; alive masks replace early returns. Every random
decision is a pure function of (seed, pixel, sample, dim) through the
counter-based samplers, so values match the reference's for the same
inputs. Sampling decisions are detached.

All four integrators are ported: ``path`` (MIS), ``simple`` (NEE at
every vertex, emission found by the BSDF counted on camera/specular
prefixes only), ``walk`` (BSDF sampling only) and ``direct``; so are the
``independent``, ``sobol``, ``stratified`` and ``sobol_global`` samplers,
visible or uniform hero wavelengths, the firefly clamp and the named
sensors (``make_sensor``). The filter is ``cfg.filter_name`` (box,
triangle, gaussian or lanczos) at ``cfg.filter_radius``.

``render_pass`` and the sharded passes (``parallel/sharding.py``) go
through one dispatch, :func:`_pass_for_pixels`, over any set of pixel ids,
so a pixel's sample values do not depend on which pass computes it.

Rendering is differentiable in the scene's material and light tables
(``models/inverse.py``): every sampling decision is detached, the kernels'
hit queries carry no gradient (as the reference's zero tangents), and the
spectral cache's interpolation kernel has a backward kernel.

A pass takes its sample index as a Python int or as a 0-d int64 tensor
on the scene's device; on a tensor it reads nothing back to the host and
makes no host copy, so ``render()`` on a CUDA scene captures one pass in
a CUDA graph (:func:`pass_graph`, the reference's jitted ``chunk_pass``)
and replays it for every pass after the first, stepping the index on the
device; the films are the eager loop's bit for bit. The sampler's seed is
a device input of that graph too, so ``render()`` keeps it across calls
(:class:`KeptPass`, as the reference keeps its compiled program in
``_RENDER_PROG_CACHE``): a later call on the same scene, camera and
config, whatever its seed, replays it for every pass.

``render_pass_compact`` bounces only the alive rays from depth 1 on. Every
sample is keyed by (pixel, sample, dim) and a dead ray's state no longer
changes, so its image is the full wavefront's. ``render()`` runs the full
wavefront unless ``cfg.compact`` asks for compaction, as in the reference.
A compacted pass stays eager (a host sync a bounce, no kept graph): on the
H100 it is bound by its launches, and at depth 8 on a 327,680-triangle
octree it takes ~4x the kept full wavefront's time (the benchmark's
``mesh.deep512`` cell, PERF.md).

``alive_fractions`` gives the per-depth alive share of one pass for
effective-ray counts, and ``li_path``, ``li_simple_path`` and
``li_random_walk`` run the bounce loop in one mode, as the reference's.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import rng
from computational_ray_tracer_tpu_torch.ops import rng_kernel
from computational_ray_tracer_tpu_torch.ops import spectrum as spec
from computational_ray_tracer_tpu_torch.ops import filters as flt
from computational_ray_tracer_tpu_torch.ops import sensor as sen
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops import shade_kernel
from computational_ray_tracer_tpu_torch.ops import spectra_data as data
from computational_ray_tracer_tpu_torch.ops.montecarlo import power_heuristic
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import materials as mat
from computational_ray_tracer_tpu_torch.models import lights as lgt
from computational_ray_tracer_tpu_torch.models.scene import (
    _packet_order, scene_anyhit, scene_intersect, scene_occluded,
    texture_lookup)
from computational_ray_tracer_tpu_torch.utils import metrics

DIM_LAMBDA = 0
DIM_FILTER = 1      # 2D
DIM_LENS = 3        # 2D
DIM_BOUNCE0 = 5
DIMS_PER_BOUNCE = 8  # bsdf 2D + bsdf 1D + light select + light pos 2D + rr


SAMPLERS = ("independent", "stratified", "sobol", "sobol_global")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Pixel sampler: ``sobol`` (Owen-scrambled, padded per pixel),
    ``stratified`` (an xs x ys grid, spp = xs * ys, jittered unless
    ``jitter`` is off), ``independent``, or ``sobol_global`` (one
    Owen-scrambled sequence over the whole image; ``width`` and ``m``, the
    image width and log2 of its scale, are derived by RenderConfig). On
    CUDA pixel ids every draw but ``sobol_global``'s is one launch of the
    sampler kernel (``ops/rng_kernel.py``), bit for bit with ``ops/rng.py``
    on the card. ``seed`` is an int or, for every kind but
    ``sobol_global``, a 0-d int64 tensor on the pixels' device holding
    ``rng_kernel.seed_word(seed)`` (the same draws; a captured pass reads
    it on the device)."""
    kind: str = "independent"
    spp: int = 16
    xs: int = 4
    ys: int = 4
    seed: int = 0
    jitter: bool = True
    width: int = 0
    m: int = 0

    def __post_init__(self):
        if self.kind not in SAMPLERS:
            raise ValueError(f"unknown sampler kind {self.kind!r}")

    def _pxpy(self, pixel):
        return pixel % self.width, pixel // self.width

    def get_1d(self, pixel, sample_idx, dim):
        with metrics.fine_span("crt.sample"):
            return self._get_1d(pixel, sample_idx, dim)

    def get_2d(self, pixel, sample_idx, dim):
        with metrics.fine_span("crt.sample"):
            return self._get_2d(pixel, sample_idx, dim)

    def _get_1d(self, pixel, sample_idx, dim):
        if self.kind == "sobol_global":
            px, py = self._pxpy(pixel)
            return rng.sobol_global_1d(self.seed, px, py, sample_idx, dim,
                                       self.m)
        return rng_kernel.draw_1d(self.kind, self.seed, pixel, sample_idx,
                                  dim, self.spp, self.jitter)

    def _get_2d(self, pixel, sample_idx, dim):
        if self.kind == "sobol_global":
            px, py = self._pxpy(pixel)
            if isinstance(dim, int) and dim == DIM_FILTER:
                # the in-pixel position comes from sequence dims 0/1
                return rng.sobol_global_pixel2d(self.seed, px, py,
                                                sample_idx, self.m)
            return rng.sobol_global_2d(self.seed, px, py, sample_idx, dim,
                                       self.m)
        return rng_kernel.draw_2d(self.kind, self.seed, pixel, sample_idx,
                                  dim, self.spp, self.xs, self.ys,
                                  self.jitter)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    resolution: tuple = (256, 256)          # (W, H)
    sampler: SamplerConfig = SamplerConfig()
    integrator: str = "path"                # path | simple | walk | direct
    max_depth: int = 5
    rr_start: int = 3                       # Russian roulette from here
    ray_eps_scale: float = 3e-5             # spawn offset / (|p| + t)
    filter_name: str = "gaussian"           # box|triangle|gaussian|lanczos
    filter_radius: tuple = (0.5, 0.5)
    lambda_mode: str = "visible"            # visible | uniform
    sensor_name: Any = None                 # None: the XYZ sensor
    clamp: float = 0.0                      # 0: no firefly clamp
    ray_eps: float = 1e-3                   # unused, as in the reference
    # render() runs each pass through render_pass_compact (the same values);
    # compact_quantum is the reference's TPU bucket size and changes nothing.
    compact: bool = False
    compact_quantum: int = 1024

    def __post_init__(self):
        if self.integrator not in ("path", "simple", "direct", "walk"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.lambda_mode not in ("visible", "uniform"):
            raise ValueError(f"unknown lambda_mode {self.lambda_mode!r}")
        if (self.sensor_name is not None
                and self.sensor_name not in data.SENSOR_CURVES):
            raise ValueError(f"unknown sensor {self.sensor_name!r}")
        if self.filter_name not in flt.FILTERS:
            raise ValueError(f"unknown filter {self.filter_name!r}")
        s = self.sampler
        if s.kind == "sobol_global" and s.width == 0:
            w, h = self.resolution
            m = max(int(np.ceil(np.log2(max(w, h, 1)))), 0)
            if s.spp > 1 << max(32 - 2 * m, 0):
                raise ValueError("sobol_global: spp * 4^m must fit in 32 "
                                 "bits")
            object.__setattr__(self, "sampler",
                               dataclasses.replace(s, width=w, m=m))


# The bounce loop's mode for each multi-bounce integrator.
_MODES = {"path": "mis", "simple": "simple", "walk": "walk"}


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
    si, mid, _ = scene_intersect(scene, o, d,
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
        lights, si.p, si.n, wl.lam, u_sel, u_pos, scene.world_radius(),
        spd_vals=svals[..., :n_l])
    f, _ = mat.bsdf_eval(mrow, si.n, si.wo, wi, wl.lam,
                         _tex_coeffs(scene, si), (eta_s, k_s),
                         enable_rough=scene.has_rough)
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


def _shades_on_card(scene, state):
    """Whether a bounce shades in the hand-written kernels
    (:func:`_bounce_step_fused`): its state is on a CUDA device and
    autograd does not need the step (grad disabled, or no tensor of the
    state or the scene requires grad). Everything else, the CPU and the
    inverse job's forward included, takes the torch route."""
    if state["lam"].device.type != "cuda":
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(x.requires_grad for x in
                   list(state.values()) + scene_leaves(scene)
                   if isinstance(x, torch.Tensor))


def _bounce_step(scene, cfg, state, depth, pixel, sample_idx, mode=None):
    """One bounce of the wavefront in ``mode`` (None: the mode of
    ``cfg.integrator``): closest hit; environment and emission (``mis``:
    weighted against the light pdf; ``simple``: on camera/specular prefixes
    only; ``walk``: always); next-event estimation with a shadow ray
    (``mis``, ``simple``); BSDF sampling and Russian roulette. Returns the
    new state. Where :func:`_shades_on_card` holds, the step after the
    closest hit is :func:`_bounce_step_fused`'s two kernels, else
    :func:`_bounce_step_torch`, their plain version. While a profiler
    records, the recorder's ``crt.shade.fused`` and ``crt.shade.torch``
    count the calls of each."""
    mode = mode or _MODES[cfg.integrator]
    fused = _shades_on_card(scene, state)
    if metrics.recording():
        metrics.count("crt.shade.fused" if fused else "crt.shade.torch", 1)
    step = _bounce_step_fused if fused else _bounce_step_torch
    return step(scene, cfg, state, depth, pixel, sample_idx, mode)


def _bounce_step_torch(scene, cfg, state, depth, pixel, sample_idx, mode):
    """:func:`_bounce_step` in PyTorch operations: the shade kernel's
    plain version."""
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
    si, mid, _ = scene_intersect(scene, o, d, t_max)
    hit = si.valid & alive
    mrow = mat.MaterialView.create(scene.materials, mid)
    tex = _tex_coeffs(scene, si)

    svals = state["svals"]
    n_l = lights.n_lights
    n_m = scene.materials.kind.shape[0]
    light_vals = svals[..., :n_l]

    miss = alive & ~si.valid
    L_env, _ = lgt.env_radiance(lights, lam, spd_vals=light_vals)
    one = torch.ones_like(state["pdf_prev"])
    if mode == "mis":
        pdf_amb = lgt.pdf_ambient_direction(lights, state["n_prev"], d)
        w_env = torch.where(state["specular"], one,
                            power_heuristic(1.0, state["pdf_prev"], 1.0,
                                            pdf_amb))
    elif mode == "walk":
        w_env = one
    else:   # simple: NEE sampled the ambient light at the previous vertex
        w_env = torch.where(state["specular"], one, torch.zeros_like(one))
    contrib = beta * L_env * w_env[..., None]
    L = L + torch.where(miss[..., None], contrib, zero(contrib))

    # One-sided (front face) emission; the same rows give eta/k.
    emit = _cache_select(svals[..., n_l:n_l + n_m], mid)
    eta_s = _cache_select(svals[..., n_l + n_m:n_l + 2 * n_m], mid)
    k_s = _cache_select(svals[..., n_l + 2 * n_m:n_l + 3 * n_m], mid)
    emit = torch.where(si.backface[..., None], zero(emit), emit)
    if mode == "mis":
        pdf_l_hit = lgt.pdf_light_direction(lights, o, d, si.t)
        w_emit = torch.where(state["specular"], one,
                             power_heuristic(1.0, state["pdf_prev"], 1.0,
                                             pdf_l_hit))
        count_emit = hit
    else:
        w_emit = one
        count_emit = hit & (state["specular"] | (mode == "walk"))
    contrib = beta * emit * w_emit[..., None]
    L = L + torch.where(count_emit[..., None], contrib, zero(contrib))

    dim0 = DIM_BOUNCE0 + depth * DIMS_PER_BOUNCE
    eps_h = spawn_eps(si, cfg)

    # next-event estimation; rays without a hit carry dead shadow rays
    if mode != "walk":
        u_sel = s.get_1d(pixel, sample_idx, dim0 + 3)
        u_pos = s.get_2d(pixel, sample_idx, dim0 + 4)
        wi_l, dist, li_val, pdf_l, lkind = lgt.sample_light(
            lights, si.p, si.n, lam, u_sel, u_pos, scene.world_radius(),
            spd_vals=light_vals)
        f, pdf_b = mat.bsdf_eval(mrow, si.n, si.wo, wi_l, lam, tex,
                                 (eta_s, k_s), enable_rough=scene.has_rough)
        cos_l = torch.clamp(torch.sum(wi_l * si.n, dim=-1), min=0.0)
        occ = scene_occluded(scene, si.p, wi_l,
                             torch.where(hit, dist, -torch.ones_like(dist)),
                             eps_h, si.n)
        nee = beta * f * li_val * (cos_l / torch.clamp(pdf_l, min=1e-12)
                                   )[..., None]
        if mode == "mis":
            # delta lights (point/distant) cannot be BSDF-sampled: weight 1
            hittable = (lkind == lgt.AREA_QUAD) | (lkind == lgt.AMBIENT)
            w_l = torch.where(hittable,
                              power_heuristic(1.0, pdf_l, 1.0, pdf_b),
                              torch.ones_like(pdf_l))
            nee = nee * w_l[..., None]
        L = L + torch.where((hit & ~occ)[..., None], nee, zero(nee))

    u2 = s.get_2d(pixel, sample_idx, dim0)
    u1 = s.get_1d(pixel, sample_idx, dim0 + 2)
    wi, w_bsdf, pdf_bsdf, is_spec, term_2nd = mat.bsdf_sample(
        mrow, si.n, si.wo, u2, u1, lam, tex_rgb_coeffs=tex,
        eta_k=(eta_s, k_s), backface=si.backface,
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


def _shade_inputs(scene, cfg, state, depth, pixel, sample_idx, mode):
    """What the shade kernel takes besides the state: the closest hit's
    surface record and material ids (as the torch route finds them), the
    bounce's draws (``u_sel``, ``u_pos`` unless ``mode`` is walk; ``u2``,
    ``u1``; ``u_rr`` with roulette) and whether roulette runs."""
    s = cfg.sampler
    o, d = state["o"], state["d"]
    t_max = torch.where(state["alive"],
                        torch.full_like(o[..., 0], float("inf")),
                        torch.full_like(o[..., 0], -1.0))
    si, mid, _ = scene_intersect(scene, o, d, t_max)
    dim0 = DIM_BOUNCE0 + depth * DIMS_PER_BOUNCE
    draws = {}
    if mode != "walk":
        draws["u_sel"] = s.get_1d(pixel, sample_idx, dim0 + 3)
        draws["u_pos"] = s.get_2d(pixel, sample_idx, dim0 + 4)
    draws["u2"] = s.get_2d(pixel, sample_idx, dim0)
    draws["u1"] = s.get_1d(pixel, sample_idx, dim0 + 2)
    roulette = depth >= cfg.rr_start
    if roulette:
        draws["u_rr"] = s.get_1d(pixel, sample_idx, dim0 + 6)
    return si, mid, draws, roulette


def _bounce_step_fused(scene, cfg, state, depth, pixel, sample_idx, mode):
    """:func:`_bounce_step` on the card: the closest hit and its surface
    record as the torch route, the draws, then one launch of the shade
    kernel (``ops/shade_kernel.py``: environment, emission, the light
    sample, BSDF evaluation and sampling, MIS, Russian roulette, the next
    ray, the shadow ray and the pending NEE term), the unchanged
    ``scene_anyhit``, and one launch that adds the term where the shadow
    ray is clear. Both launches are fine ``crt.shade`` spans."""
    si, mid, draws, roulette = _shade_inputs(scene, cfg, state, depth, pixel,
                                             sample_idx, mode)
    with metrics.fine_span("crt.shade"):
        out = shade_kernel.shade_bounce(scene, state, si, mid, draws, mode,
                                        roulette, cfg.ray_eps_scale)
    if mode != "walk":
        occ = scene_anyhit(scene, *out["shadow"])
        with metrics.fine_span("crt.shade"):
            shade_kernel.resolve(out["L"], out["nee"], occ)
    return dict(o=out["o"], d=out["d"], beta=out["beta"], L=out["L"],
                alive=out["alive"], specular=out["specular"],
                pdf_prev=out["pdf_prev"], n_prev=out["n_prev"],
                lam=state["lam"], lam_pdf=out["lam_pdf"],
                svals=state["svals"])


def _path_scan(scene, o, d, wl, pixel, sample_idx, cfg, mode=None,
               counts=False):
    """The bounce loop of the multi-bounce integrators over cfg.max_depth
    in ``mode`` (None: the mode of ``cfg.integrator``): (L, wavelengths),
    then, with ``counts``, the alive rays entering each depth (float32
    (max_depth,), on the device). Eagerly while a profiler records, their
    sum goes to the recorder's ``crt.bounce.alive`` and the lanes spent on
    them to ``crt.bounce.lanes``; nothing is counted otherwise."""
    state = _init_path_state(scene, o, d, wl)
    record = metrics.recording() and not metrics.capturing()
    alive = []
    for depth in range(cfg.max_depth):
        if counts or record:
            alive.append(state["alive"].sum(dtype=torch.float32))
        state = _bounce_step(scene, cfg, state, depth, pixel, sample_idx,
                             mode)
    if record and alive:
        metrics.count("crt.bounce.alive",
                      torch.stack(alive).sum(dtype=torch.float64))
        metrics.count("crt.bounce.lanes",
                      len(alive) * state["alive"].numel())
    out = state["L"], spec.SampledWavelengths(wl.lam, state["lam_pdf"])
    return out + (torch.stack(alive),) if counts else out


def alive_fractions(scene, camera, cfg: RenderConfig, sample_idx=0):
    """Per-depth alive-ray fractions of one wavefront pass of pixel-centre
    camera rays (no filter offset), as the reference's: the share of rays
    that enter each bounce, for effective rays/s beside the nominal count.
    The ``direct`` integrator is counted as path/MIS, as there."""
    w, h = cfg.resolution
    s = cfg.sampler
    sample_idx = int(sample_idx)
    pixel = torch.arange(w * h, dtype=torch.int64, device=scene.device)
    px = (pixel % w).to(torch.float32)
    py = (pixel // w).to(torch.float32)
    wl = _sample_wavelengths(cfg, s.get_1d(pixel, sample_idx, DIM_LAMBDA))
    o, d = camera.generate_rays(torch.stack([px + 0.5, py + 0.5], dim=-1),
                                s.get_2d(pixel, sample_idx, DIM_LENS))
    mode = {"walk": "walk", "simple": "simple"}.get(cfg.integrator, "mis")
    with torch.no_grad():
        counts = _path_scan(scene, o, d, wl, pixel, sample_idx, cfg, mode,
                            counts=True)[2]
    return counts / (w * h)


def li_path(scene, o, d, wl, pixel, sample_idx, cfg):
    """Path: NEE and BSDF-sampled emission under the power heuristic."""
    return _path_scan(scene, o, d, wl, pixel, sample_idx, cfg, mode="mis")


def li_simple_path(scene, o, d, wl, pixel, sample_idx, cfg):
    """SimplePath: NEE at every vertex, emission found by the BSDF counted
    on camera/specular prefixes only."""
    return _path_scan(scene, o, d, wl, pixel, sample_idx, cfg,
                      mode="simple")


def li_random_walk(scene, o, d, wl, pixel, sample_idx, cfg):
    """RandomWalk: BSDF sampling only, lights found by hitting them."""
    return _path_scan(scene, o, d, wl, pixel, sample_idx, cfg, mode="walk")


def make_filter(cfg: RenderConfig):
    """The config's reconstruction filter at ``cfg.filter_radius``."""
    return flt.FILTERS[cfg.filter_name](tuple(cfg.filter_radius))


def make_sensor(cfg: RenderConfig):
    """The config's pixel sensor: the XYZ sensor or a named camera."""
    return sen.PixelSensor.create(cfg.sensor_name)


def _sample_wavelengths(cfg: RenderConfig, u):
    if cfg.lambda_mode == "uniform":
        return spec.sample_uniform_wavelengths(u)
    return spec.sample_visible_wavelengths(u)


def _sensor_rgb(cfg: RenderConfig, sensor, L, wl):
    """Sensor RGB of the pass, clamped to [0, cfg.clamp] (the firefly
    clamp) or at 0 from below. ``maximum``/``minimum`` and not ``clamp``:
    at a tie they pass half the gradient, as the reference's
    ``jnp.maximum``/``jnp.clip`` do (a sample whose radiance is exactly 0,
    e.g. a camera ray on the ceiling beside the light, sits at the tie)."""
    rgb = sensor.to_sensor_rgb(L, wl)
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
    wl = _sample_wavelengths(cfg, s.get_1d(pixel, sample_idx, DIM_LAMBDA))
    fp, fw = filter_obj.sample(s.get_2d(pixel, sample_idx, DIM_FILTER))
    pixel_pos = torch.stack([px + 0.5, py + 0.5], dim=-1) + fp
    o, d = camera.generate_rays(pixel_pos,
                                s.get_2d(pixel, sample_idx, DIM_LENS))
    return pixel, wl, fw, o, d


def sample_index(sample_idx, device):
    """The sample index as the samplers take it: a Python int, or a 0-d
    int64 tensor on ``device`` (the device index a captured pass steps in
    place; one already there is used as it is)."""
    if isinstance(sample_idx, torch.Tensor):
        return sample_idx.to(device=device, dtype=torch.int64).reshape(())
    return int(sample_idx)


def _pass_for_pixels(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                     pixel, sample_idx):
    """One sample for each flat pixel id of ``pixel`` (None: every pixel):
    (sensor rgb (n, 3), filter weight (n,)). The one integrator dispatch of
    render_pass and the sharded passes. ``sample_idx``: a Python int or a
    0-d integer tensor (the same values)."""
    sample_idx = sample_index(sample_idx, scene.device)
    pixel, wl, fw, o, d = camera_wavefront(camera, cfg, filter_obj,
                                           sample_idx, scene.device, pixel)
    if cfg.integrator == "direct":
        L, wl_out = li_direct(scene, o, d, wl, pixel, sample_idx, cfg), wl
    else:
        L, wl_out = _path_scan(scene, o, d, wl, pixel, sample_idx, cfg)
    return _sensor_rgb(cfg, sensor, L, wl_out), fw


def render_pass(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                sample_idx):
    """One sample-per-pixel wavefront pass: (rgb (H, W, 3), weight (H, W))
    ready for Film.add_aligned. ``sample_idx`` is a Python int or a 0-d
    integer tensor on the scene's device; on a tensor the pass reads
    nothing back to the host, so it can be captured in a CUDA graph."""
    w, h = cfg.resolution
    rgb, fw = _pass_for_pixels(scene, camera, cfg, filter_obj, sensor, None,
                               sample_idx)
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
    value. The scatter back is out of place (``index_put``), so the pass
    is differentiable like the full wavefront. ``alive_counts``, a list,
    receives the count at each depth.

    Each count read is a coarse ``crt.compact.sync`` span; the order, the
    gather (state and pixel ids) and the scatter back are fine
    ``crt.compact.order`` / ``.gather`` / ``.scatter`` spans, whose
    profiler ranges hold their kernels' launches. While a profiler records
    (eagerly) the counts go to ``crt.bounce.alive`` and max_depth x the
    pass's lanes to ``crt.bounce.lanes``, as :func:`_path_scan` counts
    them."""
    if cfg.integrator == "direct":
        raise ValueError("compaction needs a multi-bounce integrator")
    w, h = cfg.resolution
    sample_idx = int(sample_idx)
    pixel, wl, fw, o, d = camera_wavefront(camera, cfg, filter_obj,
                                           sample_idx, scene.device)
    state = _init_path_state(scene, o, d, wl)
    counts = []
    for depth in range(cfg.max_depth):
        with metrics.span("crt.compact.sync"):
            k = int(state["alive"].sum())                # host sync
        counts.append(k)
        if k == 0:
            break
        if depth == 0:
            state = _bounce_step(scene, cfg, state, depth, pixel, sample_idx)
            continue
        with metrics.fine_span("crt.compact.order"):
            idx = _packet_order(state["o"], state["d"], state["alive"])[:k]
        with metrics.fine_span("crt.compact.gather"):
            sub = {key: v[idx] for key, v in state.items()}
            sub_pixel = pixel[idx]
        sub = _bounce_step(scene, cfg, sub, depth, sub_pixel, sample_idx)
        with metrics.fine_span("crt.compact.scatter"):
            for key in _BOUNCE_KEYS:
                state[key] = state[key].index_put((idx,), sub[key])
    if alive_counts is not None:
        alive_counts.extend(counts)
    if metrics.recording() and not metrics.capturing():
        metrics.count("crt.bounce.alive", sum(counts))
        metrics.count("crt.bounce.lanes", cfg.max_depth * pixel.numel())
    wl_out = spec.SampledWavelengths(wl.lam, state["lam_pdf"])
    rgb = _sensor_rgb(cfg, sensor, state["L"], wl_out)
    return rgb.reshape(h, w, 3), fw.reshape(h, w)


def _sum_passes(pass_fn, sample_idx0, n_passes, resolution, device):
    """sum of rgb * weight and of weight over the passes ``pass_fn(i)``,
    i = sample_idx0 .. sample_idx0 + n_passes - 1, in pass order."""
    w, h = resolution
    rgb_sum = torch.zeros((h, w, 3), device=device)
    wt_sum = torch.zeros((h, w), device=device)
    for j in range(n_passes):
        rgb, wt = pass_fn(sample_idx0 + j)
        rgb_sum = rgb_sum + rgb * wt[..., None]
        wt_sum = wt_sum + wt
    return rgb_sum, wt_sum


def render_passes(scene, camera, cfg: RenderConfig, filter_obj, sensor,
                  sample_idx0, n_passes: int):
    """n_passes samples per pixel accumulated as (rgb_sum, weight_sum), one
    eager pass after another."""
    return _sum_passes(lambda i: render_pass(scene, camera, cfg, filter_obj,
                                             sensor, i),
                       sample_index(sample_idx0, scene.device), n_passes,
                       cfg.resolution, scene.device)


def capture_sums(step_sums, step, sample_idx, resolution, device,
                 kept=False):
    """A :class:`graphs.CapturedGraph` (into the card's ``graphs.kept_pool``
    if ``kept``, else a pool of its own) each replay of which adds
    ``step_sums(idx)`` -> (rgb * weight, weight) into its static film sums
    ``state`` and steps its device index ``idx`` (first ``sample_idx``) by
    ``step`` (:func:`replay_sums`). The capture is the recorder's
    ``crt.pass.capture`` span, with the device allocations and frees it
    made (``device_allocs``, ``device_frees``); the step, a fine
    ``crt.pass``."""
    w, h = resolution
    idx = torch.full((), int(sample_idx), dtype=torch.int64, device=device)
    sums = (torch.zeros((h, w, 3), device=device),
            torch.zeros((h, w), device=device))

    def traced():
        with metrics.fine_span("crt.pass"):
            rgb, wt = step_sums(idx)
            sums[0].add_(rgb)
            sums[1].add_(wt)
            idx.add_(step)

    with metrics.span("crt.pass.capture") as span:
        before = graphs.device_allocs(idx.device)
        pool = graphs.kept_pool(idx.device) if kept else None
        graph = graphs.CapturedGraph(traced, idx, sums, pool)
        after = graphs.device_allocs(idx.device)
        span.attrs.update(device_allocs=after[0] - before[0],
                          device_frees=after[1] - before[1])
    return graph


def pass_graph(pass_fn, sample_idx, resolution, device):
    """One sample pass captured (:func:`capture_sums`), the port of the
    reference's jitted ``chunk_pass``: a replay adds rgb * weight and
    weight of ``pass_fn(idx)`` in the order of :func:`render_passes`."""
    def weighted(idx):
        rgb, wt = pass_fn(idx)
        return rgb * wt[..., None], wt
    return capture_sums(weighted, 1, sample_idx, resolution, device)


def replay_sums(graph, n, rgb_sum=None, weight_sum=None):
    """Replay :func:`capture_sums`'s ``graph`` ``n`` times onto (rgb_sum,
    weight_sum) (None: zeros); returns its static sums, which the next
    replay overwrites."""
    for static, start in zip(graph.state, (rgb_sum, weight_sum)):
        if start is None:
            static.zero_()
        else:
            static.copy_(start)
    graph.replay(n)
    return graph.state


def accumulate(pass_fn, film, stop, chunk=1, progress=None, capture=False,
               kept=None):
    """Passes film.spp_done .. stop - 1 of ``pass_fn(sample_idx)`` -> (rgb,
    weight) summed ``chunk`` at a time (:func:`render_passes`' order) and
    each sum added to the film; ``progress(i, film)`` after each. With
    ``capture`` the first pass runs eagerly and every later one is a
    replay of one :func:`pass_graph` (the same bits), released before the
    call returns unless ``kept`` (a :class:`KeptPass`, with ``capture``)
    keeps it: the call leaves the graph it captured in ``kept.graph``, and
    where ``kept.graph`` is set already every pass, the first included, is
    a replay of it from film.spp_done, with nothing eager and no capture.

    The call is the recorder's root span ``crt.frame``; its eager passes
    are ``crt.pass.eager`` spans and the graph's release
    ``crt.pass.release``. Its counters ``crt.graph.kept`` and
    ``crt.graph.captured`` are 1 where it replayed a kept graph or
    captured one."""
    h, w = film.weight_sum.shape
    resolution, device = (w, h), film.weight_sum.device
    i = int(film.spp_done)
    graph = None if kept is None else kept.graph
    with metrics.span("crt.frame", root=True):
        if graph is not None and i < stop:
            graph.set_index(i)
            metrics.count("crt.graph.kept", 1)
        while i < stop:
            n = min(chunk, stop - i)
            if graph is not None:
                rgb_sum, wt_sum = replay_sums(graph, n)
            else:
                first = 1 if capture else n
                with metrics.span("crt.pass.eager"):
                    rgb_sum, wt_sum = _sum_passes(pass_fn, i, first,
                                                  resolution, device)
                if capture and i + 1 < stop:
                    graph = pass_graph(pass_fn, i + 1, resolution, device)
                    metrics.count("crt.graph.captured", 1)
                    if n > first:
                        rgb_sum, wt_sum = replay_sums(graph, n - first,
                                                      rgb_sum, wt_sum)
            film = filmmod.Film(film.rgb_sum + rgb_sum,
                                film.weight_sum + wt_sum, film.spp_done + n)
            i += n
            if progress is not None:
                progress(i - 1, film)
        if kept is not None:
            kept.graph = graph
        elif graph is not None:
            graph.release()
    return film


def scene_leaves(obj):
    """Every value ``obj`` (a scene) holds, depth first through dataclasses
    (their type, then their attributes), tuples, lists and dicts: the
    tensors and arrays themselves, and the other values."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = (type(obj),) + tuple(vars(obj).items())
    elif isinstance(obj, dict):
        obj = tuple(obj.items())
    if isinstance(obj, (tuple, list)):
        return [type(obj), len(obj)] + [x for v in obj
                                        for x in scene_leaves(v)]
    return [obj]


def kept_key(scene, camera, cfg: RenderConfig, device, layout=()):
    """The key under which :func:`render` keeps its captured pass for
    ``scene`` on ``device`` (the scene's), and ``sharding.render_distributed``
    its step graph, or None where neither keeps one: off
    the card, for a compacted render (eager, with host reads), and while a
    profiler records (the call's fine spans and ``crt.bounce.*`` counters
    come from its own eager pass and capture, as without a kept pass; the
    kept one is left as it is). Decided from what the call can observe,
    before a pass runs. Calls with equal keys replay one graph, which reads
    the scene's tensors at the addresses it captured and the seed from the
    device. The key holds:

    - every tensor and array of the scene (:func:`scene_leaves`) by
      identity, its other values by value: a rebound field captures anew;
    - the camera by value;
    - ``cfg`` with the sampler's seed at 0, but for ``sobol_global``, whose
      draws take an int seed (``ops/rng.py``): its seed stays in the key.
      ``spp`` stays: the Sobol' and stratified draws permute over it
      (``rng_kernel.draw_params``), so a graph captured at one ``spp``
      draws other samples at another;
    - the device;
    - ``layout``: what else the graph was captured on (the sharded step's
      mesh, ``sharding.mesh_key``); empty for :func:`render`."""
    device = torch.device(device)
    if (device.type != "cuda" or (cfg.compact and cfg.integrator != "direct")
            or metrics.recording()):
        return None
    if cfg.sampler.kind != "sobol_global":
        cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
            cfg.sampler, seed=0))
    leaves = tuple(("id", id(x)) if isinstance(x, (torch.Tensor, np.ndarray))
                   else x for x in scene_leaves(scene))
    return leaves, camera, cfg, device, tuple(layout)


class KeptPass:
    """What :func:`render` keeps across calls: the captured
    :func:`pass_graph` (``graph``; ``sharding.render_distributed`` keeps
    its step graph in one of its own), the device seed its draws read
    (``seed``, 0-d int64; None for ``sobol_global``), the config, filter
    and sensor it was captured with, and, once :meth:`hold` has run, its
    ``key`` (:func:`kept_key`), every tensor its replays read outside the
    graph's pool that nothing else keeps alive (``pins``) and the
    ``finalizer`` that releases the graph when the scene, held weakly, is
    collected (or at exit)."""

    def __init__(self, device, cfg: RenderConfig):
        self.graph = self.seed = self.key = self.pins = None
        self.finalizer = None
        if cfg.sampler.kind != "sobol_global":
            self.seed = torch.zeros((), dtype=torch.int64, device=device)
            cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
                cfg.sampler, seed=self.seed))
        self.cfg = cfg
        self.filter, self.sensor = make_filter(cfg), make_sensor(cfg)

    def hold(self, scene, camera, cfg: RenderConfig, forget=None,
             layout=()):
        """Take the key and the pins of the scene as the capture left it
        (with the tables its first pass built, such as the mesh's vertex
        table): the scene's leaves, so that no rebound field's id is
        reused while the key holds it, and the camera's frame, which sits
        in a bounded cache. ``forget(self)`` (default :func:`render`'s)
        runs when the scene, held weakly, is collected."""
        self.key = kept_key(scene, camera, cfg, scene.device, layout)
        self.pins = (scene_leaves(scene), camera.frame(scene.device))
        self.finalizer = weakref.finalize(scene, forget or _forget, self)

    def release(self):
        """Release the graph, or, while a capture records, at the next
        kept call (:func:`release_held`), and stop the finalizer."""
        self.finalizer.detach()
        if metrics.capturing():
            _RELEASE_LATER.append(self)
        else:
            self.graph.release()


# The one KeptPass render() holds: the last key's, or None.
_KEPT = None
# Graphs whose scene was collected while a capture ran, released at the
# next kept call: no graph is destroyed while a capture records.
_RELEASE_LATER = []


def release_held():
    """Release the graphs :meth:`KeptPass.release` held back."""
    while _RELEASE_LATER:
        _RELEASE_LATER.pop().graph.release()


def _forget(kept):
    """Drop ``kept`` if it is the kept pass, and release its graph."""
    global _KEPT
    if kept is _KEPT:
        _KEPT = None
        kept.release()


@torch.no_grad()
def render(scene, camera, cfg: RenderConfig, film=None, progress=None,
           passes=None, chunk=1):
    """Progressive render: cfg.sampler.spp passes accumulated into a Film.
    Resume from ``film`` (continues at ``film.spp_done``); ``passes`` stops
    early; ``chunk`` passes are summed before each film update.

    On a CUDA scene the passes replay one captured CUDA graph
    (:func:`pass_graph`, the reference's one device program a chunk; the
    same bits as the eager loop, :func:`accumulate` without capture), kept
    across calls in one :class:`KeptPass`. A call whose :func:`kept_key`
    matches the kept one (the same scene tensors, camera, config but for
    the seed, and device) writes its seed and start index into the graph's
    device inputs and replays every pass; another runs the first pass
    eagerly, captures a new graph for the later ones and keeps it in place
    of the old, which is released (``crt.pass.release``), as it is when its
    scene is collected. The sensor returned is the kept one. A call made
    while a profiler records keeps nothing and replays nothing kept: it
    captures its own graph and releases it before it returns. With
    ``cfg.compact`` (and a multi-bounce integrator) each pass goes through
    :func:`render_pass_compact`, one pass a film update, eagerly, as the
    reference's; the values are the full wavefront's."""
    global _KEPT
    if film is None:
        film = filmmod.Film.create(cfg.resolution, device=scene.device)
    stop = cfg.sampler.spp if passes is None else min(
        cfg.sampler.spp, int(film.spp_done) + passes)
    key = kept_key(scene, camera, cfg, scene.device)
    if key is None:
        filter_obj, sensor = make_filter(cfg), make_sensor(cfg)
        compact = cfg.compact and cfg.integrator != "direct"
        one_pass = render_pass_compact if compact else render_pass
        film = accumulate(
            lambda i: one_pass(scene, camera, cfg, filter_obj, sensor, i),
            film, stop, 1 if compact else chunk, progress,
            not compact and scene.device.type == "cuda")
        return film, sensor
    release_held()
    kept = _KEPT
    if kept is not None and kept.key != key:
        _forget(kept)
        kept = None
    if kept is None:
        kept = KeptPass(scene.device, cfg)
    if kept.seed is not None:
        kept.seed.fill_(rng_kernel.seed_word(cfg.sampler.seed))
    film = accumulate(
        lambda i: render_pass(scene, camera, kept.cfg, kept.filter,
                              kept.sensor, i),
        film, stop, chunk, progress, capture=True, kept=kept)
    if kept.graph is not None and kept.key is None:
        kept.hold(scene, camera, cfg)
        _KEPT = kept
    return film, kept.sensor
