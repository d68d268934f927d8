"""Textured frames: ``frames`` (one client renders whole frames through
``integrator.render`` in a closed loop, each frame's sampler seed or focal
distance drawn from (--seed, k)) on a configuration whose ``texture``
key puts an image on some of its materials. Its window, profiled span,
end-to-end metric and release are ``frames``'s.

The configuration's ``texture`` (``kind`` "checker": a ``size`` x
``size`` linear-RGB image of ``squares`` x ``squares`` squares of its two
``colors``) multiplies the albedo of the materials it names
(``materials``). It is a key of its own, not ``use_texture`` in the
materials, which ``scenes.build_scene`` hands to the frozen copy as they
are: set-up puts it on the port's scene (the texel coefficients through
the port's ``models/scene.texture_from_rgb``, ``use_texture`` on those
materials), and the check on the reference's through
``reference/textured.py``.

The check (``check`` in the cell's file) draws ``frames`` of the window's
frames from the seed and, at ``pixels`` pixels drawn from the seed (null:
every pixel), compares their film sums and resolved images with the plain
reference's, each by its relative L1 gap."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench import compare, scenes
from gpubench.traffic import frames

window = frames.window
profile = frames.profile
end_to_end = frames.end_to_end
release = frames.release


def texture_rgb(config):
    """The configuration's texture image (H, W, 3) float32 linear RGB."""
    spec = config["texture"]
    if spec["kind"] != "checker":
        raise ValueError(f"unknown texture kind {spec['kind']!r}")
    n, squares = spec["size"], spec["squares"]
    c0, c1 = (np.asarray(c, np.float32) for c in spec["colors"])
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    odd = ((ii // (n // squares) + jj // (n // squares)) % 2).astype(bool)
    img = np.zeros((n, n, 3), np.float32)
    img[odd] = c1
    img[~odd] = c0
    return img


def port_scene(port, config, arrays, device, texture=None, albedos=None):
    """The port's Scene of the configuration with its texture (or the
    image ``texture``) on the materials the texture names."""
    scene = scenes.build_scene(port, config, arrays, device, albedos)
    use = scene.materials.use_texture.clone()
    use[config["texture"]["materials"]] = True
    img = texture_rgb(config) if texture is None else texture
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials,
                                             use_texture=use),
        texture=port.scene.texture_from_rgb(img, scene.device))


def reference_scene(ref_scene, config):
    """The reference's scene (``scenes.build_scene`` of the frozen copy)
    with the configuration's texture."""
    from gpubench.reference import textured
    return textured.attach(ref_scene, texture_rgb(config),
                           config["texture"]["materials"])


def setup(cell, config, device):
    port = scenes.namespace(scenes.PORT)
    arrays = scenes.mesh_arrays(config)
    st = frames.State(cell, config, device, port, arrays,
                      port_scene(port, config, arrays, device))
    frames.render_frame(st, frames.frame_params(cell, config, 0, 0),
                        cell["warmup_spp"])
    return st


def reference_film(ref, ts, st, params, pixels):
    """(rgb_sum (P, 3), weight_sum (P,), resolved image (P, 3)) of the
    plain reference for one frame at the flat pixel ids ``pixels``."""
    from gpubench.reference import textured
    seed, focal = params
    camera, cfg = scenes.view(ref, st.config, st.cell, focal, seed)
    sensor = ref.integ.make_sensor(cfg)
    with torch.no_grad():
        rgb, wt = textured.path_film(ts, camera, cfg, sensor, pixels,
                                     cfg.sampler.spp)
        image = ref.film.Film(rgb[:, None], wt[:, None]).resolve(sensor)
    return rgb, wt, image[:, 0]


def check(st, rec, seed, ref, ref_scene, lowered=None):
    """{number name: value}: the worst over the sampled frames of the
    film's and the resolved image's relative L1 gap to the reference.
    ``lowered`` (the control) puts the reference computed under that
    context in the program's place."""
    ts = reference_scene(ref_scene, st.config)
    pixels = frames.check_pixels(st, seed)
    worst = {"rgb_rel_l1": 0.0, "weight_rel_l1": 0.0, "image_rel_l1": 0.0}
    for kept in rec["sample"]:
        params = rec["frames"][kept["k"]]["params"]
        want = reference_film(ref, ts, st, params, pixels)
        if lowered is None:
            film = kept["film"]
            got = (film.rgb_sum.reshape(-1, 3)[pixels],
                   film.weight_sum.reshape(-1)[pixels],
                   kept["image"].reshape(-1, 3)[pixels.cpu()])
        else:
            with lowered():
                got = reference_film(ref, ts, st, params, pixels)
        for name, g, w in zip(worst, got, want):
            worst[name] = max(worst[name], compare.rel_l1(g, w))
    return worst
