"""Differentiable inverse rendering (``computational_ray_tracer_tpu/models/
inverse.py``, BASELINE config 5).

Pixel radiance is differentiable in the scene's material and light
parameters through the wavefront integrators, with detached sampling: every
sampling decision (wavelengths, lens and filter offsets, BSDF directions,
Russian roulette, light picks, hit ids) carries no gradient, while the
radiance evaluated at those samples does. Visibility and silhouette
gradients are out of scope, as in the reference.

Parameters are plain dicts of leaf tensors; ``extract``/``insert`` move
them out of and into a Scene with ``dataclasses.replace`` (the Scene caches
nothing derived from albedo, emission or light scale).

:func:`optimize` is the reference's Adam loop, with :class:`DeviceAdam`
(``optax.adam``'s update in float32 tensor ops), every step run eagerly:
the eager loop that the port's captured steps equal bit for bit.
"""

from __future__ import annotations

import dataclasses as dc

import torch

from gpubench.reference.crt.models import integrator as integ


def albedo_and_emission_params(scene):
    """(extract, insert) for the albedo coefficients, the light scales and
    the materials' dense emission (the Cornell recovery of BASELINE
    config 5)."""
    def extract(s):
        return {"albedo_coeffs": s.materials.albedo_coeffs,
                "light_scale": s.lights.scale,
                "emission": s.materials.emission}

    def insert(s, p):
        mats = dc.replace(s.materials, albedo_coeffs=p["albedo_coeffs"],
                          emission=p["emission"])
        lts = dc.replace(s.lights, scale=p["light_scale"])
        return dc.replace(s, materials=mats, lights=lts)
    return extract, insert


def make_render_fn(camera, cfg: integ.RenderConfig, spp=None):
    """A differentiable deterministic render: sample indices 0..spp-1, the
    weighted mean sensor-RGB image (no film). Returns (render_image,
    sensor); render_image(scene) -> (H, W, 3)."""
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    n_spp = spp if spp is not None else cfg.sampler.spp

    def render_image(scene):
        w, h = cfg.resolution
        total = torch.zeros((h, w, 3), device=scene.device)
        wsum = torch.zeros((h, w), device=scene.device)
        for i in range(n_spp):
            rgb, wt = integ.render_pass(scene, camera, cfg, filter_obj,
                                        sensor, i)
            total = total + rgb * wt[..., None]
            wsum = wsum + wt
        return total / torch.clamp(wsum[..., None], min=1e-12)

    return render_image, sensor


def make_loss_fn(camera, cfg, extract_insert, target):
    """loss(params, scene): the mean squared difference between the render
    of ``scene`` with ``params`` inserted and ``target``."""
    _, insert = extract_insert
    render_image, _ = make_render_fn(camera, cfg)

    def loss(params, scene):
        img = render_image(insert(scene, params))
        return torch.mean((img - target) ** 2)

    return loss


def leaf_params(params):
    """A copy of a parameter dict as leaf tensors that require grad."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


class DeviceAdam:
    """``optax.adam(lr)``'s update (the reference's optimizer) in float32
    tensor ops on the parameters in place, with ``zero_grad``/``step`` as
    ``torch.optim`` has them. The step count is a 0-d int32 tensor on the
    parameters' device and the bias corrections are float32 tensors, as
    the port's. Each expression is optax's, in its order:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, the update
    -lr (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps), p + update, with
    optax's defaults b1, b2, eps."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr):
        self.params = list(params)
        self.lr = lr
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        """Every gradient to None."""
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        self.count.add_(1)
        b1, b2 = self.B1, self.B2
        c1 = 1.0 - torch.pow(b1, self.count)
        c2 = 1.0 - torch.pow(b2, self.count)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * g ** 2 + b2 * nu)
            p.add_(-self.lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.EPS)))


def optimize(scene, camera, cfg, extract_insert, target, steps=50, lr=2e-2,
             callback=None):
    """Adam descent on the scene's parameters against a target image, with
    :class:`DeviceAdam` (the reference's ``optax.adam(lr)``), every step
    eagerly. Returns (scene with the final parameters, the parameters, the
    loss before each step). ``callback(i, params, loss)`` after each step
    gets copies of the parameters."""
    extract, insert = extract_insert
    params = leaf_params(extract(scene))
    opt = DeviceAdam(list(params.values()), lr=lr)
    loss_fn = make_loss_fn(camera, cfg, extract_insert, target)
    history = []
    for i in range(steps):
        opt.zero_grad()
        loss = loss_fn(params, scene)
        loss.backward()
        opt.step()
        history.append(float(loss.detach()))
        if callback:
            callback(i, {k: v.detach().clone() for k, v in params.items()},
                     history[-1])
    params = {k: v.detach() for k, v in params.items()}
    return insert(scene, params), params, history
