"""Filter, film and sensor validation app
(``computational_ray_tracer_tpu/apps/filter_film_test.py``): each filter's
curve against the histogram of its samples, and its integral against the
mean sample weight; the ColorChecker's white and red swatches through the
XYZ sensor and two camera sensors (their spectral lookups through the
interpolation kernel on the card); visible-wavelength sampling against its
pdf; a sigmoid-polynomial reflectance. Report: ``filter_film.json``."""

from __future__ import annotations

import json
import os

import numpy as np

FILTER_NAMES = ("box", "triangle", "gaussian", "lanczos")
SENSORS = (None, "canon_eos_5d_mkiv", "sony_ilce_7m3")


def filter_samples(name, n, device):
    """The (offsets, weights) of ``name``'s filter on the app's n draws."""
    from computational_ray_tracer_tpu_torch.apps import uniform
    from computational_ray_tracer_tpu_torch.ops import filters as flt
    return flt.FILTERS[name]().sample(uniform(0, (n, 2), device))


def main(outdir="out", n=60_000, device="cuda"):
    import torch
    from computational_ray_tracer_tpu_torch.apps import uniform
    from computational_ray_tracer_tpu_torch.ops import color as colorlib
    from computational_ray_tracer_tpu_torch.ops import filters as flt
    from computational_ray_tracer_tpu_torch.ops import sensor as sen
    from computational_ray_tracer_tpu_torch.ops import spectrum as spec
    from computational_ray_tracer_tpu_torch.utils.plot import Graph2D

    os.makedirs(outdir, exist_ok=True)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    report = {}

    for name in FILTER_NAMES:
        f = flt.FILTERS[name]()
        p, w = filter_samples(name, n, device)
        g = Graph2D(f"{name} filter: x-marginal of samples + f(x, 0)")
        g.plot_histogram(p[:, 0], bins=80,
                         range=(-f.radius[0], f.radius[0]),
                         label="sampled x")
        g.plot_function(
            lambda x: f.evaluate(torch.stack([t32(x), t32(np.zeros_like(x))],
                                             dim=-1)),
            -f.radius[0], f.radius[0], label="f(x, 0)")
        g.save(os.path.join(outdir, f"filter_{name}.png"))
        report[name] = {"integral": float(f.integral),
                        "mc_integral": float(torch.mean(w))}

    # the swatches through the XYZ sensor and two camera sensors
    swatches = sen.macbeth_reflectances()
    wl = spec.sample_visible_wavelengths(
        torch.linspace(0.001, 0.999, 256, device=device))
    illum = spec.sample_dense(t32(colorlib.SRGB.illuminant), wl.lam)
    for sensor_name in SENSORS:
        s = sen.PixelSensor.create(sensor_name)
        rgbs = []
        for i in range(24):
            L = spec.sample_dense(t32(swatches[i]), wl.lam) * illum
            cam_rgb = torch.mean(s.to_sensor_rgb(L, wl), dim=0)
            rgbs.append(colorlib.SRGB.to_rgb(
                s.sensor_rgb_to_xyz(cam_rgb)).cpu().numpy())
        report[f"sensor_{sensor_name or 'XYZ'}"] = {
            "white_swatch": [round(float(v), 4) for v in rgbs[18]],
            "red_swatch": [round(float(v), 4) for v in rgbs[14]],
        }

    lam = spec.sample_visible_wavelength(uniform(3, (n,), device))
    g = Graph2D("visible-wavelength importance sampling")
    g.plot_histogram(lam, bins=94, range=(360, 830), label="sampled lambda")
    g.plot_function(lambda x: spec.visible_wavelengths_pdf(t32(x)), 360, 830,
                    label="pdf")
    g.save(os.path.join(outdir, "visible_lambda.png"))

    alb = colorlib.RGBAlbedoSpectrum(
        colorlib.fit_rgb_to_spectrum([0.6, 0.25, 0.1]).to(device))
    g = Graph2D("rgb2spec sigmoid reflectance for (0.6, 0.25, 0.1)")
    g.plot_function(lambda x: alb(t32(x)), 360, 830)
    g.save(os.path.join(outdir, "rgb2spec.png"))

    with open(os.path.join(outdir, "filter_film.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report
