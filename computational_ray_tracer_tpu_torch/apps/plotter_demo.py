"""Plotter demo app (``computational_ray_tracer_tpu/apps/plotter_demo.py``):
two functions and a noisy scatter through ``utils/plot.Graph2D``, to
``plotter_demo.png``. The plot is drawn on the host; ``device`` is taken
for the apps' common command line and not used."""

from __future__ import annotations

import os

import numpy as np


def main(outdir="out", device="cuda"):
    from computational_ray_tracer_tpu_torch.utils import plot

    os.makedirs(outdir, exist_ok=True)
    g = plot.Graph2D(title="Plotter demo", xlabel="x", ylabel="y")
    g.plot_function(np.sin, -2 * np.pi, 2 * np.pi, label="sin x")
    g.plot_function(lambda x: np.sin(2 * x) * 0.5, -2 * np.pi, 2 * np.pi,
                    label="0.5 sin 2x")
    rng = np.random.default_rng(0)
    xs = rng.uniform(-6, 6, 80)
    g.plot_points(xs, np.sin(xs) + rng.normal(0, 0.08, 80), label="noisy")
    path = os.path.join(outdir, "plotter_demo.png")
    g.save(path)
    print(f"wrote {path}")
    return path
