"""The plain reference's films over a subset of pixels, from the frozen
copy's own stages: the camera wavefront, the plain intersection and the
estimators. A pixel's samples depend only on (seed, pixel, sample, dim),
so a pixel's sums here are the whole frame's at that pixel."""

from __future__ import annotations

import torch

from gpubench.reference.crt import entry
from gpubench.reference.crt.models import integrator as integ
from gpubench.reference.crt.models.scene import scene_intersect
from gpubench.reference.precision import q as stored


def path_film(scene, camera, cfg, sensor, pixels, spp):
    """(rgb_sum (P, 3), weight_sum (P,)) of ``spp`` passes of the
    configured integrator at the flat pixel ids ``pixels`` (None: every
    pixel), summed in pass order."""
    filt = integ.make_filter(cfg)
    rgb_sum = wt_sum = 0.0
    for i in range(spp):
        rgb, wt = integ._pass_for_pixels(scene, camera, cfg, filt, sensor,
                                         pixels, i)
        rgb_sum = rgb_sum + rgb * wt[..., None]
        wt_sum = wt_sum + wt
    return rgb_sum, wt_sum


def canonical_film(scene, camera, cfg, sensor, pixels, spp):
    """(rgb_sum (P, 3), weight_sum (P,)) of the canonical frame's ``spp``
    passes at the flat pixel ids ``pixels``: the copy's ``canonical_pass``
    with the camera rays of every pass intersected in one call. Li at a
    hit is 0.3 F1(lambda) + max(n . (0, 0, -1), 0) white(lambda)
    gray(lambda); no shadow rays; the sensor RGB clamped to [0, 1]."""
    dev = scene.device
    filt = integ.make_filter(cfg)
    waves = [integ.camera_wavefront(camera, cfg, filt, i, dev, pixels)
             for i in range(spp)]
    o = torch.cat([w[3] for w in waves])
    d = torch.cat([w[4] for w in waves])
    si, _ = scene_intersect(scene, o, d,
                               torch.full_like(o[..., 0], float("inf")))
    f1, white, gray, light_wi = entry._canonical_spectra(str(dev))
    n = pixels.numel()
    rgb_sum = wt_sum = 0.0
    for i, (_, wl, fw, _, _) in enumerate(waves):
        rows = slice(i * n, (i + 1) * n)
        normal, valid = si.n[rows], si.valid[rows]
        cosw = torch.clamp(torch.sum(normal * light_wi, dim=-1), 0.0, 1.0)
        L = (0.3 * f1(wl.lam)
             + cosw[..., None] * white(wl.lam) * gray(wl.lam))
        L = stored(torch.where(valid[..., None], L, torch.zeros_like(L)))
        rgb = torch.clamp(stored(sensor.to_sensor_rgb(L, wl)), 0.0, 1.0)
        rgb_sum = rgb_sum + rgb * fw[..., None]
        wt_sum = wt_sum + fw
    return rgb_sum, wt_sum
