"""The bounce step's shading: the CUDA kernel and its wrapper.

The kernel source is ``csrc/shade.cu`` (the lane's code in
``csrc/shade.cuh``); ``kernels/build.py`` compiles it with nvcc for
``sm_90a`` at first use. It replaces no Pallas kernel: the JAX package
shades with jnp operations in ``_bounce_step``, which XLA fuses. Its plain
version is the port's torch route of ``models/integrator.py``
``_bounce_step`` (``models/materials.py``, ``models/lights.py``), which
runs those operations as ~600 ATen kernels a bounce.

- :func:`shade_bounce` launches ``crt_shade_bounce`` once: from the surface
  record, the path state and the bounce's draws it gives the next state,
  the shadow ray and the pending NEE term, bit for bit with the torch route
  on the card (the einsum of a scene with three or more lights aside: its
  cuBLAS order is not fixed).
- :func:`resolve` launches ``crt_shade_resolve`` once: L += the NEE term
  where the shadow ray is clear, in place.

Both take CUDA tensors only and raise on anything else, on an input the
kernel does not take and on a refused launch. They launch on torch's
current stream, allocate with ``torch.empty`` and read nothing back to the
host, so they capture into a CUDA graph. ``LAUNCHES`` and
``LAUNCHES_RESOLVE`` count the launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import spectra_data as data
from computational_ray_tracer_tpu_torch.ops.mesh_intersect_kernel import (
    check_tensor)
from computational_ray_tracer_tpu_torch.ops.rng_kernel import _reciprocal

LAUNCHES = 0
LAUNCHES_RESOLVE = 0

MODES = ("mis", "simple", "walk")
S = 8
MAX_LIGHTS = 32

_P = ctypes.c_void_p
# CrtShadeArgs of csrc/shade.cuh, field for field.
_POINTERS = (
    "o", "d", "beta", "L", "lam", "lam_pdf", "alive", "specular", "pdf_prev",
    "n_prev", "t", "valid", "p", "n", "uv", "wo", "backface", "mid", "u_sel",
    "u_pos", "u2", "u1", "u_rr", "svals", "mat_kind", "mat_coeffs",
    "mat_use_texture", "mat_roughness", "light_kind", "light_position",
    "light_direction", "light_edge1", "light_edge2", "light_scale",
    "texture", "o_out", "d_out", "beta_out", "L_out", "alive_out",
    "specular_out", "pdf_prev_out", "n_prev_out", "lam_pdf_out", "shadow_o",
    "shadow_d", "shadow_t", "nee")
_INTS = ("n_lanes", "n_lights", "n_mats", "n_cols", "mode", "roulette",
         "has_rough", "tex_w", "tex_h")
_FLOATS = ("ray_eps_scale", "world_radius", "inv_pi", "inv_n_lights", "inv_s",
           "inv_lam_range")


class ShadeArgs(ctypes.Structure):
    """``CrtShadeArgs``: the launch's pointers and uniforms, passed to the
    kernel by value."""
    _fields_ = ([(k, _P) for k in _POINTERS]
                + [(k, ctypes.c_int32) for k in _INTS]
                + [(k, ctypes.c_float) for k in _FLOATS])


def _flat(name, x, width, dtype, device, n):
    """``x`` as a contiguous (n,) or (n, width) tensor, checked."""
    x = x.reshape((n,) if width is None else (n, width)).contiguous()
    check_tensor(name, x, x.shape, dtype, device)
    return x


def prepare(scene, state, si, mid, draws, mode, roulette, ray_eps_scale):
    """The launch's :class:`ShadeArgs` and its outputs, for the lanes of
    ``state`` (the ``_bounce_step`` dict) on any device: ``si`` and ``mid``
    the closest hit's surface record and material ids, ``draws`` the
    bounce's ``u_sel``, ``u_pos``, ``u2``, ``u1``, ``u_rr`` (the first two
    and the last may be None where ``mode`` or ``roulette`` reads none).
    Returns (args, outputs, inputs): ``outputs`` the next state's entries,
    ``shadow`` (o, d, t_max) and ``nee`` (None in walk mode); ``inputs``
    the flattened tensors the pointers read, to be kept alive."""
    if mode not in MODES:
        raise ValueError(f"the shade kernel has no mode {mode!r}")
    lam = state["lam"]
    batch = lam.shape[:-1]
    if lam.shape[-1] != S:
        raise ValueError(f"the shade kernel takes {S} wavelengths a lane, "
                         f"not {lam.shape[-1]}")
    n = int(np.prod(batch, dtype=np.int64))
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes exceed the kernel's 2^31 range")
    dev = lam.device
    f32, b8, i64 = torch.float32, torch.bool, torch.int64
    mats, lights = scene.materials, scene.lights
    n_l, n_m = int(lights.kind.shape[0]), int(mats.kind.shape[0])
    if not 1 <= n_l <= MAX_LIGHTS:
        raise ValueError(f"the shade kernel takes 1 to {MAX_LIGHTS} lights, "
                         f"not {n_l}")
    svals = state["svals"]
    if tuple(svals.shape) != tuple(batch) + (S, n_l + 3 * n_m):
        raise ValueError(f"svals has shape {tuple(svals.shape)}, expected "
                         f"{tuple(batch) + (S, n_l + 3 * n_m)}")
    walk = mode == "walk"
    inputs = dict(
        o=_flat("o", state["o"], 3, f32, dev, n),
        d=_flat("d", state["d"], 3, f32, dev, n),
        beta=_flat("beta", state["beta"], S, f32, dev, n),
        L=_flat("L", state["L"], S, f32, dev, n),
        lam=_flat("lam", lam, S, f32, dev, n),
        lam_pdf=_flat("lam_pdf", state["lam_pdf"], S, f32, dev, n),
        alive=_flat("alive", state["alive"], None, b8, dev, n),
        specular=_flat("specular", state["specular"], None, b8, dev, n),
        pdf_prev=_flat("pdf_prev", state["pdf_prev"], None, f32, dev, n),
        n_prev=_flat("n_prev", state["n_prev"], 3, f32, dev, n),
        t=_flat("si.t", si.t, None, f32, dev, n),
        valid=_flat("si.valid", si.valid, None, b8, dev, n),
        p=_flat("si.p", si.p, 3, f32, dev, n),
        n=_flat("si.n", si.n, 3, f32, dev, n),
        uv=_flat("si.uv", si.uv, 2, f32, dev, n),
        wo=_flat("si.wo", si.wo, 3, f32, dev, n),
        backface=_flat("si.backface", si.backface, None, b8, dev, n),
        mid=_flat("mid", mid, None, i64, dev, n),
        u2=_flat("u2", draws["u2"], 2, f32, dev, n),
        u1=_flat("u1", draws["u1"], None, f32, dev, n),
        svals=_flat("svals", svals, S * (n_l + 3 * n_m), f32, dev, n),
        mat_kind=_flat("materials.kind", mats.kind, None, i64, dev, n_m),
        mat_coeffs=_flat("materials.albedo_coeffs", mats.albedo_coeffs, 3,
                         f32, dev, n_m),
        mat_use_texture=_flat("materials.use_texture", mats.use_texture,
                              None, b8, dev, n_m),
        mat_roughness=_flat("materials.roughness", mats.roughness, None, f32,
                            dev, n_m),
        light_kind=_flat("lights.kind", lights.kind, None, i64, dev, n_l),
        light_position=_flat("lights.position", lights.position, 3, f32, dev,
                             n_l),
        light_direction=_flat("lights.direction", lights.direction, 3, f32,
                              dev, n_l),
        light_edge1=_flat("lights.edge1", lights.edge1, 3, f32, dev, n_l),
        light_edge2=_flat("lights.edge2", lights.edge2, 3, f32, dev, n_l),
        light_scale=_flat("lights.scale", lights.scale, None, f32, dev, n_l))
    if not walk:
        inputs["u_sel"] = _flat("u_sel", draws["u_sel"], None, f32, dev, n)
        inputs["u_pos"] = _flat("u_pos", draws["u_pos"], 2, f32, dev, n)
    if roulette:
        inputs["u_rr"] = _flat("u_rr", draws["u_rr"], None, f32, dev, n)
    tex_h = tex_w = 0
    if scene.texture is not None:
        tex_h, tex_w = int(scene.texture.shape[0]), int(scene.texture.shape[1])
        if tex_h < 2 or tex_w < 2:
            raise ValueError(f"the shade kernel takes a texture of at least "
                             f"2 x 2 texels, not {tex_h} x {tex_w}")
        inputs["texture"] = _flat("texture", scene.texture, tex_w * 3, f32,
                                  dev, tex_h)
    empty = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype,
                                                  device=dev)
    out = dict(o_out=empty(n, 3), d_out=empty(n, 3), beta_out=empty(n, S),
               L_out=empty(n, S), alive_out=empty(n, dtype=b8),
               specular_out=empty(n, dtype=b8), pdf_prev_out=empty(n),
               n_prev_out=empty(n, 3), lam_pdf_out=empty(n, S))
    if not walk:
        out.update(shadow_o=empty(n, 3), shadow_d=empty(n, 3),
                   shadow_t=empty(n), nee=empty(n, S))
    ptrs = {k: v.data_ptr() for k, v in {**inputs, **out}.items()}
    args = ShadeArgs(
        **{k: ptrs.get(k) for k in _POINTERS},
        n_lanes=n, n_lights=n_l, n_mats=n_m, n_cols=n_l + 3 * n_m,
        mode=MODES.index(mode), roulette=int(bool(roulette)),
        has_rough=int(bool(scene.has_rough)), tex_w=tex_w, tex_h=tex_h,
        ray_eps_scale=float(ray_eps_scale),
        world_radius=float(scene.world_radius()),
        inv_pi=_reciprocal(math.pi), inv_n_lights=_reciprocal(n_l),
        inv_s=_reciprocal(S),
        inv_lam_range=_reciprocal(data.LAMBDA_MAX - data.LAMBDA_MIN))
    shape3, shape_s = tuple(batch) + (3,), tuple(batch) + (S,)
    outputs = dict(
        o=out["o_out"].reshape(shape3), d=out["d_out"].reshape(shape3),
        beta=out["beta_out"].reshape(shape_s),
        L=out["L_out"].reshape(shape_s),
        alive=out["alive_out"].reshape(batch),
        specular=out["specular_out"].reshape(batch),
        pdf_prev=out["pdf_prev_out"].reshape(batch),
        n_prev=out["n_prev_out"].reshape(shape3),
        lam_pdf=out["lam_pdf_out"].reshape(shape_s),
        shadow=None if walk else (out["shadow_o"].reshape(shape3),
                                  out["shadow_d"].reshape(shape3),
                                  out["shadow_t"].reshape(batch)),
        nee=None if walk else out["nee"].reshape(shape_s))
    return args, outputs, inputs


def _check(err, what):
    from computational_ray_tracer_tpu_torch.kernels import build
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({build.error_string(err)})")


def shade_bounce(scene, state, si, mid, draws, mode, roulette,
                 ray_eps_scale):
    """One launch of ``crt_shade_bounce`` on the lanes of ``state`` (CUDA
    tensors; arguments as :func:`prepare`): the next state's entries
    ``o``, ``d``, ``beta``, ``L`` (without the NEE term), ``alive``,
    ``specular``, ``pdf_prev``, ``n_prev``, ``lam_pdf``, and ``shadow``
    (origin, direction, t_max for ``scene_anyhit``) and ``nee`` (None in
    walk mode)."""
    global LAUNCHES
    from computational_ray_tracer_tpu_torch.kernels import build
    dev = state["lam"].device
    if dev.type != "cuda":
        raise ValueError(f"the shade kernel runs on a CUDA device, not {dev}")
    args, outputs, inputs = prepare(scene, state, si, mid, draws, mode,
                                    roulette, ray_eps_scale)
    if args.n_lanes == 0:
        return outputs
    _check(build.load_library().crt_shade_bounce(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream),
        "shade kernel")
    LAUNCHES += 1
    return outputs


def resolve(L, nee, occluded):
    """One launch of ``crt_shade_resolve``: ``L += nee`` in place on the
    lanes whose shadow ray ``occluded`` (bool) is clear, as the torch
    route's ``L + where(hit & ~occ, nee, 0)`` (``nee`` is 0 on lanes
    without a hit). Returns ``L``."""
    global LAUNCHES_RESOLVE
    from computational_ray_tracer_tpu_torch.kernels import build
    dev = L.device
    if dev.type != "cuda":
        raise ValueError(f"the resolve kernel runs on a CUDA device, not "
                         f"{dev}")
    n = L.numel() // S
    check_tensor("L", L, L.shape, torch.float32, dev)
    check_tensor("nee", nee, L.shape, torch.float32, dev)
    check_tensor("occluded", occluded, L.shape[:-1], torch.bool, dev)
    if n == 0:
        return L
    _check(build.load_library().crt_shade_resolve(
        L.data_ptr(), nee.data_ptr(), occluded.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream), "resolve kernel")
    LAUNCHES_RESOLVE += 1
    return L
