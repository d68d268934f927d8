"""The plain reference of a textured triangle mesh in an octree under the
path integrator (MIS) with shadow rays: what the frozen copy
(``reference/crt``) lacks for the ``mesh.flagship`` cell, built on its
camera wavefront, samplers, lights, spectra, materials, plain closest-hit
traversal and film. Plain PyTorch in float32, nothing of the port, no
kernel; like the frozen copy it stores its intermediates through
``reference/precision.py``, so the control lowers them too.

Departures from the frozen copy, each the port's own behaviour:

- textures (the copy's ``MaterialTable.build`` refuses them): a material
  flagged in :class:`TexturedScene`'s ``use_texture`` multiplies its
  albedo by the texture's reflectance at the hit's uv
  (:func:`texture_albedo`), a bilinear fetch of sigmoid coefficients
  (:func:`texture_lookup`, as the port's ``models/scene.py`` specifies
  it); each texel's coefficients come from the sRGB coefficient table
  (:func:`texture_coeffs`: a trilinear lookup in the copy's own
  ``ops/data/rgb2spec_srgb_64.npy``); a conductor's tint stays untextured;
- shadow rays in the octree (the copy's ``scene_anyhit`` raises there):
  :func:`octree_anyhit`, a plain traversal that stops at a ray's first
  hit, with the closest-hit traversal's node order and slab test;
- the bounce (:func:`_bounce_step`) is the copy's ``_bounce_step`` with
  those two, and each traversal can log its rays, live rays, triangle
  tests and node pops (:func:`pass_launches`, the yardstick of
  ``metrics/octree_roofline.flagship.py``).

Its films and passes run with TF32 off (:func:`float32`), whatever the
process has set, and restore the setting after.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from gpubench.reference.crt.models import integrator as integ
from gpubench.reference.crt.models import lights as lgt
from gpubench.reference.crt.models import materials as mat
from gpubench.reference.crt.models.scene import TYPE_MESH, scene_surface
from gpubench.reference.crt.ops import color as colorlib
from gpubench.reference.crt.ops import mesh_intersect_kernel as mik
from gpubench.reference.crt.ops import octree as octmod
from gpubench.reference.crt.ops import spectrum as spec
from gpubench.reference.crt.ops.shapes import fp_gamma
from gpubench.reference.crt.ops.spectra_data import DATA_DIR
from gpubench.reference.precision import q as stored

_TABLE = {}


@contextlib.contextmanager
def float32():
    """Matrix products in float32 within the block: TF32 off."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p


def _srgb_table():
    """The (64, 64, 64, 3) sRGB sigmoid-coefficient table on the CPU."""
    if "srgb" not in _TABLE:
        path = os.path.join(DATA_DIR, "rgb2spec_srgb_64.npy")
        _TABLE["srgb"] = torch.as_tensor(np.load(path).astype(np.float32))
    return _TABLE["srgb"]


def rgb_to_coeffs(rgb):
    """Sigmoid coefficients (..., 3) of RGB reflectances (..., 3) on the
    CPU: trilinear interpolation of the table at rgb in [0, 1]^3."""
    coeffs = _srgb_table()
    r = coeffs.shape[0]
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
                c = c + wt[..., None] * coeffs[
                    i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]
    return c


def texture_coeffs(texture_rgb, device):
    """(H, W, 3) linear RGB -> each texel's sigmoid coefficients on
    ``device``."""
    img = np.asarray(texture_rgb, np.float32)
    return rgb_to_coeffs(torch.as_tensor(img.reshape(-1, 3))).reshape(
        img.shape).to(device)


@dataclasses.dataclass
class TexturedScene:
    """The frozen copy's Scene (``scene``: mesh, octree, materials,
    lights) with a texture of sigmoid coefficients (``texture`` (H, W,
    3)) and the materials that use it (``use_texture`` (M,) bool)."""
    scene: object
    texture: torch.Tensor
    use_texture: torch.Tensor

    @property
    def device(self):
        return self.scene.device


def attach(scene, texture_rgb, materials):
    """``scene`` with the texture ``texture_rgb`` (H, W, 3 linear RGB) on
    the materials of ids ``materials``."""
    use = torch.zeros(scene.materials.kind.shape[0], dtype=torch.bool,
                      device=scene.device)
    use[list(materials)] = True
    return TexturedScene(scene, texture_coeffs(texture_rgb, scene.device),
                         use)


def texture_lookup(texture, uv):
    """Bilinear fetch of sigmoid coefficients from the texture image."""
    h, w, _ = texture.shape
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (w - 1)
    y = torch.clamp(1.0 - uv[..., 1], 0.0, 1.0) * (h - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return ((1 - fy) * ((1 - fx) * texture[y0, x0] + fx * texture[y0, x0 + 1])
            + fy * ((1 - fx) * texture[y0 + 1, x0]
                    + fx * texture[y0 + 1, x0 + 1]))


def texture_albedo(mrow, use_tex, lam, tex):
    """The material's albedo, times the texture's reflectance where the
    ray's material uses the texture."""
    alb = colorlib.sigmoid_polynomial(mrow.albedo_coeffs, lam)
    t = colorlib.sigmoid_polynomial(tex, lam)
    return torch.where(use_tex[..., None], alb * t, alb)


def bsdf_eval(mrow, use_tex, n, wo, wi, lam, tex):
    """The copy's ``bsdf_eval`` with the textured albedo."""
    cos_i = torch.sum(n * wi, dim=-1)
    same_hemi = (torch.sum(n * wo, dim=-1) > 0) & (cos_i > 0)
    alb = texture_albedo(mrow, use_tex, lam, tex)
    is_diffuse = (mrow.kind == mat.LAMBERTIAN) & same_hemi
    f = torch.where(is_diffuse[..., None], alb * mat.INV_PI,
                    torch.zeros_like(alb))
    pdf = torch.where(is_diffuse, torch.clamp(cos_i, min=0.0) * mat.INV_PI,
                      torch.zeros_like(cos_i))
    return f, pdf


def bsdf_sample(mrow, use_tex, n, wo, u2, u1, lam, tex, eta_k, backface):
    """The copy's ``bsdf_sample`` with the textured albedo as the
    Lambertian weight (its other kinds unchanged)."""
    wi, weight, pdf, is_spec, term = mat.bsdf_sample(
        mrow, n, wo, u2, u1, lam, eta_k=eta_k, backface=backface)
    weight = torch.where((mrow.kind == mat.LAMBERTIAN)[..., None],
                         texture_albedo(mrow, use_tex, lam, tex), weight)
    return wi, weight, pdf, is_spec, term


def _log(log, mode, t_max, tests, pops):
    """Append one traversal's counts to ``log`` (None: nothing): its rays,
    the live ones (t_max > 0, the ones the kernel queues) and their
    triangle tests and node pops."""
    if log is None:
        return
    live = t_max.reshape(-1) > 0.0
    log.append({"mode": mode, "rays": t_max.numel(),
                "live": int(live.sum()),
                "tests": int(tests.reshape(-1)[live].sum()),
                "pops": int(pops.reshape(-1)[live].sum())})


def closest(ts, o, d, t_max, log=None):
    """Closest hit in the scene's octree: (SurfaceInfo, material id), the
    copy's ``scene_intersect`` over its plain traversal (with the node
    pops counted)."""
    scene = ts.scene
    packed = scene.packed_octree
    tm, ti, mb1, mb2, tests, pops = octmod.octree_traverse(
        o, d, t_max, packed.tree, packed.tri_verts, packed.tri_mask,
        pops=True)
    _log(log, "closest", t_max, tests, pops)
    zero = torch.zeros(o.shape[:-1], device=o.device)
    izero = torch.zeros(o.shape[:-1], dtype=torch.int64, device=o.device)
    better = tm < t_max
    hit = (torch.where(better, tm, t_max),
           torch.where(better, TYPE_MESH, izero),
           torch.where(better, ti.to(torch.int64), izero),
           torch.where(better, mb1, zero), torch.where(better, mb2, zero))
    return scene_surface(scene, o, d, hit)


def octree_anyhit(o, d, t_max, tree, mesh, tri_mask=None):
    """Is any triangle hit in (0, t_max)? The copy's lockstep
    ``octree_traverse`` with t_best held at t_max and a ray's traversal
    ended at its first hit. Returns (hit, triangle tests, node pops), each
    shaped as the rays' batch; a leaf's tests are its triangles up to the
    first that hits, in slot order."""
    tri_verts = getattr(mesh, "tri_verts", mesh)
    batch = o.shape[:-1]
    dev = o.device
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    t_max = t_max.reshape(-1)
    n = o.shape[0]
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.sign(d) * 1e-20 + 1e-30,
                              d)
    ray = mik.ray_shear(d)
    g3 = 1.0 + 2.0 * fp_gamma(3)
    cap = tree.leaf_tris.shape[1]
    mask = None if tri_mask is None else tri_mask.to(torch.bool)
    slots = torch.arange(cap, device=dev)

    stack = torch.zeros((n, octmod.STACK_SIZE), dtype=torch.int64,
                        device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)   # root in slot 0
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    pop_count = torch.zeros(n, dtype=torch.int32, device=dev)
    tests = torch.zeros(n, dtype=torch.int32, device=dev)
    eight = torch.arange(8, device=dev)

    def leaf_test(r, leaf):
        tri = tree.leaf_tris[leaf]                       # (m, cap)
        ok = tri >= 0
        tri = torch.clamp(tri, min=0)
        if mask is not None:
            ok &= mask[tri]
        t, _, _ = mik.watertight(
            o[r].T[:, :, None].unbind(0), [x[r, None] for x in ray],
            t_max[r, None], tri_verts[:, tri])
        found = ok & torch.isfinite(t)
        any_hit = found.any(1)
        first = torch.where(any_hit, torch.argmax(found.to(torch.int32), 1),
                            torch.full_like(any_hit, cap - 1,
                                            dtype=torch.int64))
        tests[r] += (ok & (slots[None, :] <= first[:, None])).sum(
            1, dtype=torch.int32)
        hit[r[any_hit]] = True
        sp[r[any_hit]] = 0                               # the ray stops

    active = torch.arange(n, device=dev)
    while active.numel():
        top = sp[active] - 1
        sp[active] = top
        pop_count[active] += 1
        node = stack[active, top]
        oa = o[active]
        t0 = (tree.node_lo[node] - oa) * inv_d[active]
        t1 = (tree.node_hi[node] - oa) * inv_d[active]
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1) * g3
        box = (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max[active])
        c0 = tree.node_child0[node]
        push = box & (c0 >= 0)
        rp = active[push]
        stack[rp[:, None], top[push, None] + eight] = c0[push, None] + eight
        sp[rp] += 8
        leaf = box & (c0 < 0)
        rl = active[leaf]
        lid = tree.node_leaf_id[node[leaf]]
        step = max(1, octmod._LEAF_PAIRS_PER_CHUNK // max(cap, 1))
        for s in range(0, rl.numel(), step):
            leaf_test(rl[s:s + step], lid[s:s + step])
        active = active[sp[active] > 0]

    return tuple(x.reshape(batch) for x in (hit, tests, pop_count))


def occluded(ts, p, wi, dist, eps, n, log=None):
    """The copy's ``scene_occluded`` (origin offset along n toward wi's
    hemisphere) over :func:`octree_anyhit`."""
    eps = torch.as_tensor(eps, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1])
    s = torch.sign(torch.sum(wi * n, dim=-1))
    o = p + n * (s * eps)[..., None]
    t_max = dist * (1.0 - 1e-3) - eps
    packed = ts.scene.packed_octree
    hit, tests, pops = octree_anyhit(o, wi, t_max, packed.tree,
                                     packed.tri_verts, packed.tri_mask)
    _log(log, "anyhit", t_max, tests, pops)
    return hit


def _bounce_step(ts, cfg, state, depth, pixel, sample_idx, log=None):
    """The copy's ``_bounce_step`` (path/MIS) on the textured octree
    scene: closest hit; environment and emission weighted against the
    light pdf; next-event estimation behind an any-hit shadow ray; BSDF
    sampling and Russian roulette, with the textured albedo."""
    scene = ts.scene
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
    si, mid = closest(ts, o, d, t_max, log)
    hit = si.valid & alive
    mrow = mat.MaterialView.create(scene.materials, mid)
    use_tex = ts.use_texture[torch.clamp(mid, 0, ts.use_texture.shape[0]
                                         - 1)]
    tex = texture_lookup(ts.texture, si.uv)

    svals = state["svals"]
    n_l = lights.n_lights
    n_m = scene.materials.kind.shape[0]
    light_vals = svals[..., :n_l]

    miss = alive & ~si.valid
    L_env, _ = lgt.env_radiance(lights, light_vals)
    one = torch.ones_like(state["pdf_prev"])
    pdf_amb = lgt.pdf_ambient_direction(lights, state["n_prev"], d)
    w_env = torch.where(state["specular"], one,
                        integ.power_heuristic(1.0, state["pdf_prev"], 1.0,
                                              pdf_amb))
    contrib = beta * L_env * w_env[..., None]
    L = L + torch.where(miss[..., None], contrib, zero(contrib))

    emit = integ._cache_select(svals[..., n_l:n_l + n_m], mid)
    eta_s = integ._cache_select(svals[..., n_l + n_m:n_l + 2 * n_m], mid)
    k_s = integ._cache_select(svals[..., n_l + 2 * n_m:n_l + 3 * n_m], mid)
    emit = torch.where(si.backface[..., None], zero(emit), emit)
    pdf_l_hit = lgt.pdf_light_direction(lights, o, d, si.t)
    w_emit = torch.where(state["specular"], one,
                         integ.power_heuristic(1.0, state["pdf_prev"], 1.0,
                                               pdf_l_hit))
    contrib = beta * emit * w_emit[..., None]
    L = L + torch.where(hit[..., None], contrib, zero(contrib))

    dim0 = integ.DIM_BOUNCE0 + depth * integ.DIMS_PER_BOUNCE
    eps_h = integ.spawn_eps(si, cfg)

    u_sel = s.get_1d(pixel, sample_idx, dim0 + 3)
    u_pos = s.get_2d(pixel, sample_idx, dim0 + 4)
    wi_l, dist, li_val, pdf_l, lkind = lgt.sample_light(
        lights, si.p, si.n, lam, u_sel, u_pos, scene.world_radius(),
        spd_vals=light_vals)
    f, pdf_b = bsdf_eval(mrow, use_tex, si.n, si.wo, wi_l, lam, tex)
    cos_l = torch.clamp(torch.sum(wi_l * si.n, dim=-1), min=0.0)
    occ = occluded(ts, si.p, wi_l,
                   torch.where(hit, dist, -torch.ones_like(dist)), eps_h,
                   si.n, log)
    nee = beta * f * li_val * (cos_l / torch.clamp(pdf_l, min=1e-12)
                               )[..., None]
    hittable = (lkind == lgt.AREA_QUAD) | (lkind == lgt.AMBIENT)
    w_l = torch.where(hittable,
                      integ.power_heuristic(1.0, pdf_l, 1.0, pdf_b),
                      torch.ones_like(pdf_l))
    nee = nee * w_l[..., None]
    L = L + torch.where((hit & ~occ)[..., None], nee, zero(nee))

    u2 = s.get_2d(pixel, sample_idx, dim0)
    u1 = s.get_1d(pixel, sample_idx, dim0 + 2)
    wi, w_bsdf, pdf_bsdf, is_spec, term_2nd = bsdf_sample(
        mrow, use_tex, si.n, si.wo, u2, u1, lam, tex, (eta_s, k_s),
        si.backface)
    beta_new = beta * w_bsdf
    lam_pdf = state["lam_pdf"]
    done = spec.SampledWavelengths(lam, lam_pdf).secondary_terminated()
    collapse = (hit & term_2nd & ~done)[..., None]
    lam_pdf = torch.where(collapse, torch.cat(
        [lam_pdf[..., :1] / S, zero(lam_pdf[..., 1:])], -1), lam_pdf)
    beta_new = torch.where(collapse, torch.cat(
        [beta_new[..., :1], zero(beta_new[..., 1:])], -1), beta_new)

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


def _pass_for_pixels(ts, camera, cfg, filter_obj, sensor, pixel,
                     sample_idx, log=None):
    """One sample for each flat pixel id of ``pixel`` (None: every pixel):
    (sensor rgb (n, 3), filter weight (n,)) at the int ``sample_idx``."""
    if cfg.integrator != "path":
        raise ValueError(f"no pass of the {cfg.integrator!r} integrator")
    pixel, wl, fw, o, d = integ.camera_wavefront(
        camera, cfg, filter_obj, sample_idx, ts.device, pixel)
    state = integ._init_path_state(ts.scene, o, d, wl)
    for depth in range(cfg.max_depth):
        state = _bounce_step(ts, cfg, state, depth, pixel, sample_idx, log)
    wl_out = spec.SampledWavelengths(wl.lam, state["lam_pdf"])
    return integ._sensor_rgb(cfg, sensor, state["L"], wl_out), fw


def path_film(ts, camera, cfg, sensor, pixels, spp):
    """(rgb_sum (P, 3), weight_sum (P,)) of ``spp`` passes at the flat
    pixel ids ``pixels`` (None: every pixel), summed in pass order."""
    filt = integ.make_filter(cfg)
    rgb_sum = wt_sum = 0.0
    with float32():
        for i in range(spp):
            rgb, wt = _pass_for_pixels(ts, camera, cfg, filt, sensor, pixels,
                                       i)
            rgb_sum = rgb_sum + rgb * wt[..., None]
            wt_sum = wt_sum + wt
    return rgb_sum, wt_sum


def pass_launches(ts, camera, cfg, sample_idx=0, pixels=None):
    """The traversals of one pass at the int ``sample_idx`` over the flat
    pixel ids ``pixels`` (None: every pixel), in launch order (closest
    hit then any hit at each depth): [{"mode", "rays", "live", "tests",
    "pops"}], the tests and pops of the live rays alone."""
    log = []
    with torch.no_grad(), float32():
        _pass_for_pixels(ts, camera, cfg, integ.make_filter(cfg),
                         integ.make_sensor(cfg), pixels, sample_idx, log)
    return log

