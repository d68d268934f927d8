"""Sampler validation app (``computational_ray_tracer_tpu/apps/
sampler_test.py``): histogram-against-pdf plots of every 1-D sampler, the
concentric disk's r^2 and the cosine hemisphere's cos(theta), and the
point sets of the independent, stratified and Sobol'-Owen pixel samplers
(the same points on every run and device)."""

from __future__ import annotations

import os

import numpy as np


def main(outdir="out", n=100_000, device="cuda"):
    """Writes the plots; returns their paths."""
    import torch
    from computational_ray_tracer_tpu_torch.apps import uniform
    from computational_ray_tracer_tpu_torch.ops import rng
    from computational_ray_tracer_tpu_torch.ops import sampling as smp
    from computational_ray_tracer_tpu_torch.utils.plot import Graph2D

    os.makedirs(outdir, exist_ok=True)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    u = uniform(0, (n,), device)
    u2 = uniform(1, (n, 2), device)
    paths = []

    def save(g, name):
        paths.append(g.save(os.path.join(outdir, name)))

    cases_1d = [
        ("linear", smp.sample_linear(u, 1.0, 3.0),
         lambda x: smp.linear_pdf(t32(x), 1.0, 3.0), (0, 1)),
        ("tent", smp.sample_tent(u, 2.0),
         lambda x: smp.tent_pdf(t32(x), 2.0), (-2, 2)),
        ("exponential", smp.sample_exponential(u, 1.5),
         lambda x: smp.exponential_pdf(t32(x), 1.5), (0, 4)),
        ("normal", smp.sample_normal(u, 0.0, 1.0),
         lambda x: smp.normal_pdf(t32(x)), (-4, 4)),
        ("logistic", smp.sample_logistic(torch.clamp(u, 1e-6, 1 - 1e-6), 0.7),
         lambda x: smp.logistic_pdf(t32(x), 0.7), (-5, 5)),
    ]
    for name, samples, pdf, (a, b) in cases_1d:
        g = Graph2D(f"{name} sampler: histogram vs pdf")
        g.plot_histogram(samples, bins=80, range=(a, b), label="samples")
        g.plot_function(pdf, a, b, label="pdf")
        save(g, f"sampler_{name}.png")

    d = smp.sample_uniform_disk_concentric(u2)
    g = Graph2D("concentric disk: r^2 histogram (should be uniform)")
    g.plot_histogram(torch.sum(d * d, dim=-1), bins=64, range=(0, 1))
    g.plot_function(lambda x: np.ones_like(x), 0, 1, label="uniform")
    save(g, "sampler_disk_r2.png")

    h = smp.sample_cosine_hemisphere(u2)
    g = Graph2D("cosine hemisphere: cos(theta) histogram vs 2z")
    g.plot_histogram(h[:, 2], bins=64, range=(0, 1))
    g.plot_function(lambda x: 2 * x, 0, 1, label="pdf 2z")
    save(g, "sampler_cosine_z.png")

    # pixel-sampler point sets: repeated runs land on the same points
    spp = 64
    idx = torch.arange(spp, device=device)
    for name, pts in [
        ("independent", torch.stack([rng.independent_1d(0, 5, idx, 0),
                                     rng.independent_1d(0, 5, idx, 1)], 1)),
        ("stratified", rng.stratified_2d(0, 5, idx, 0, 8, 8)),
        ("sobol_owen", rng.sobol_owen_2d(0, 5, idx, 0, spp=spp)),
    ]:
        g = Graph2D(f"{name} pixel sampler: {spp} points")
        g.plot_points(pts[:, 0], pts[:, 1], s=14)
        g.set_range(0, 1, 0, 1)
        save(g, f"points_{name}.png")
    print(f"sampler plots -> {outdir}")
    return paths
