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
(``optax.adam``'s update in float32 tensor ops, its step count on the
parameters' device) on every device. On a CUDA scene its step 0 runs
eagerly and every later step is a replay of one captured CUDA graph (a
``graphs.CapturedGraph``, the port of the reference's jitted ``step``: zero
the gradients, the loss forward, its backward and the Adam update); on the
CPU every step runs eagerly.
"""

from __future__ import annotations

import dataclasses as dc

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.utils import metrics


def albedo_params(scene):
    """(extract, insert) for the material albedo coefficients."""
    def extract(s):
        return {"albedo_coeffs": s.materials.albedo_coeffs}

    def insert(s, p):
        return dc.replace(s, materials=dc.replace(
            s.materials, albedo_coeffs=p["albedo_coeffs"]))
    return extract, insert


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
        total, wsum = integ.render_passes(scene, camera, cfg, filter_obj,
                                          sensor, 0, n_spp)
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
    parameters' device and the bias corrections are float32 tensors, so a
    step reads nothing back to the host and can be captured in a CUDA
    graph (``torch.optim.Adam`` reads its step count with ``.item()`` and
    corrects in host float64). Each expression is optax's, in its order:
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
        """Every gradient to None (a capture then takes them from its
        pool)."""
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
    :class:`DeviceAdam` (the reference's ``optax.adam(lr)``). Returns
    (scene with the final parameters, the parameters, the loss before each
    step). ``callback(i, params, loss)`` after each step gets copies of
    the parameters. On a CUDA scene step 0 runs eagerly and every later
    step replays one captured step (the same bits as the eager loop); on
    the CPU every step runs eagerly."""
    return _optimize(scene, camera, cfg, extract_insert, target, steps, lr,
                     callback, capture=scene.device.type == "cuda")


def make_step(camera, cfg, extract_insert, target, params, scene, opt):
    """The training step of :func:`optimize`: () -> the loss (detached)
    of the parameters before the update, which ``opt`` then makes."""
    loss_fn = make_loss_fn(camera, cfg, extract_insert, target)

    def step():
        opt.zero_grad()
        loss = loss_fn(params, scene)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def _optimize(scene, camera, cfg, extract_insert, target, steps, lr,
              callback, capture=False):
    """:func:`optimize`; with ``capture`` (a CUDA scene) step 0 runs on a
    side stream and every later step replays step 1's capture, else every
    step runs eagerly (the card's bitwise reference).

    The call is the recorder's root span ``crt.job``; a replay's launch is
    a ``crt.step.launch`` span. Between two replays, from the loss read
    back to the next replay launched (the history, the parameters' copies,
    the callback and the launch), runs a ``crt.step.host`` span."""
    with metrics.span("crt.job", root=True):
        extract, insert = extract_insert
        params = leaf_params(extract(scene))
        opt = DeviceAdam(list(params.values()), lr=lr)
        step = make_step(camera, cfg, extract_insert, target, params, scene,
                         opt)
        history, graph, host = [], None, None
        for i in range(steps):
            if capture and i == 0:
                loss = graphs.on_side_stream(step)
            elif capture:
                if graph is None:
                    opt.zero_grad()
                    graph = graphs.CapturedGraph(step)
                with metrics.span("crt.step.launch"):
                    loss = graph.replay()
            else:
                loss = step()
            if host is not None:
                host.close()
            value = float(loss)
            host = (metrics.span("crt.step.host").open()
                    if graph is not None and i + 1 < steps else None)
            history.append(value)
            if callback:
                callback(i, {k: v.detach().clone()
                             for k, v in params.items()}, history[-1])
        params = {k: v.detach() for k, v in params.items()}
    return insert(scene, params), params, history


@torch.no_grad()
def finite_difference_grad(f, params, eps=1e-3):
    """Central finite differences of a scalar function of a dict of tensors,
    each perturbed element in float64 and cast back to float32 (the
    reference oracle for the gradient tests)."""
    grads = {}
    for key, leaf in params.items():
        base = leaf.detach().cpu().numpy().astype(np.float64)
        g = np.zeros_like(base)
        for idx in np.ndindex(base.shape):
            vals = []
            for sign in (1.0, -1.0):
                pert = base.copy()
                pert[idx] += sign * eps
                p = dict(params)
                p[key] = torch.as_tensor(pert.astype(np.float32),
                                         device=leaf.device)
                vals.append(float(f(p)))
            g[idx] = (vals[0] - vals[1]) / (2 * eps)
        grads[key] = torch.as_tensor(g.astype(np.float32))
    return grads
