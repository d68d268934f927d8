"""Spectrum and colour validation app
(``computational_ray_tracer_tpu/apps/spectrum_color.py``): plots of every
spectrum class and of the CIE, illuminant, glass and metal curves; uniform
against visible-importance wavelength sampling; known-answer colour
conversions in ``spectrum_color.json``."""

from __future__ import annotations

import json
import os

import numpy as np


def main(outdir="out", device="cuda"):
    import torch
    from computational_ray_tracer_tpu_torch.ops import color as colorlib
    from computational_ray_tracer_tpu_torch.ops import spectra_data as data
    from computational_ray_tracer_tpu_torch.ops import spectrum as spec
    from computational_ray_tracer_tpu_torch.utils.plot import Graph2D

    os.makedirs(outdir, exist_ok=True)
    lam = np.arange(360.0, 831.0, 1.0)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=device)

    g = Graph2D("CIE 1931 color-matching functions (analytic fits)")
    g.plot_line(lam, data.CIE_X, label="x̄")
    g.plot_line(lam, data.CIE_Y, label="ȳ")
    g.plot_line(lam, data.CIE_Z, label="z̄")
    g.save(os.path.join(outdir, "cie_cmf.png"))

    g = Graph2D("standard illuminants")
    for name in ["stdillum-A", "stdillum-D50", "stdillum-D65",
                 "stdillum-F2", "stdillum-F11"]:
        g.plot_line(lam, data.get_named_spectrum(name), label=name)
    g.save(os.path.join(outdir, "illuminants.png"))

    g = Graph2D("spectrum distribution classes")
    g.plot_line(lam, spec.ConstantSpectrum(0.6)(lam_t), label="constant")
    g.plot_line(lam, spec.BlackbodySpectrum(5000.0)(lam_t),
                label="blackbody 5000K")
    pw = spec.PiecewiseLinearSpectrum.from_interleaved(
        [400.0, 0.1, 550.0, 0.9, 700.0, 0.3], device=device)
    g.plot_line(lam, pw(lam_t), label="piecewise linear")
    alb = colorlib.RGBAlbedoSpectrum(
        colorlib.fit_rgb_to_spectrum([0.2, 0.6, 0.3]).to(device))
    g.plot_line(lam, alb(lam_t), label="rgb albedo")
    g.save(os.path.join(outdir, "spectrum_classes.png"))

    g = Graph2D("glass dispersion n(lambda) (Sellmeier)")
    for name in ["glass-BK7", "glass-SF11", "glass-LASF9"]:
        g.plot_line(lam, data.GLASS_IOR[name], label=name)
    g.save(os.path.join(outdir, "glasses.png"))
    g = Graph2D("metal complex IoR")
    for name in ["metal-Au", "metal-Ag", "metal-Cu"]:
        g.plot_line(lam, data.METAL_ETA[name], label=name + " eta")
        g.plot_line(lam, data.METAL_K[name], label=name + " k")
    g.save(os.path.join(outdir, "metals.png"))

    us = torch.linspace(0.001, 0.999, 4096, device=device)
    g = Graph2D("hero-wavelength sampling: uniform vs visible-importance")
    g.plot_histogram(spec.sample_uniform_wavelengths(us).lam.reshape(-1),
                     bins=94, range=(360, 830), label="uniform")
    g.plot_histogram(spec.sample_visible_wavelengths(us).lam.reshape(-1),
                     bins=94, range=(360, 830), label="visible")
    g.save(os.path.join(outdir, "lambda_sampling.png"))

    # known-answer conversions
    report = {}
    d65 = spec.DenselySampledSpectrum.from_named("stdillum-D65", device)
    xyz = spec.spectrum_to_xyz(d65, device).cpu().numpy()
    xy = xyz[:2] / xyz.sum()
    report["d65_chromaticity"] = [round(float(v), 4) for v in xy]
    report["d65_expected"] = [0.3127, 0.3290]

    white = torch.ones(3, device=device)
    report["srgb_white_to_xyz"] = [
        round(float(v), 4) for v in colorlib.SRGB.to_xyz(white).cpu()]
    report["expected_whitepoint_Y"] = 1.0

    rgb = torch.tensor([0.7, 0.3, 0.2], device=device)
    p3 = colorlib.convert_rgb_colorspace(rgb, colorlib.SRGB, colorlib.DCI_P3)
    back = colorlib.convert_rgb_colorspace(p3, colorlib.DCI_P3, colorlib.SRGB)
    report["srgb_to_p3"] = [round(float(v), 4) for v in p3.cpu()]
    report["p3_round_trip_err"] = float((back - rgb).abs().max())

    with open(os.path.join(outdir, "spectrum_color.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report
