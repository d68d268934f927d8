"""ODE solver app (``computational_ray_tracer_tpu/apps/ode_app.py``):
Euler, RK2 and RK4 on y' = -2y + sin t, y(0) = 1, to t = 4 at 64, 128 and
256 steps, against the analytic solution; the empirical order from
halving the step. Report: ``ode.json``."""

from __future__ import annotations

import json
import os

import numpy as np


def analytic(t):
    """y(t) = 1.2 e^{-2t} + (2 sin t - cos t) / 5."""
    t = np.asarray(t)
    return 1.2 * np.exp(-2 * t) + (2.0 * np.sin(t) - np.cos(t)) / 5.0


def main(outdir="out", device="cuda"):
    import torch
    from computational_ray_tracer_tpu_torch.models import simulation as sim
    from computational_ray_tracer_tpu_torch.utils import plot

    os.makedirs(outdir, exist_ok=True)
    f = lambda t, y: -2.0 * y + torch.sin(t)
    t1 = 4.0
    g = plot.Graph2D(title="ODE y' = -2y + sin t", xlabel="t", ylabel="y")
    errors = {}
    for name, solver in sim.SOLVERS.items():
        errs = []
        for n in (64, 128, 256):
            ts, ys = solver(f, 1.0, 0.0, t1 / n, n, device=device)
            ys = ys.cpu().numpy()
            errs.append(float(abs(ys[-1] - analytic(t1))))
            if n == 128:
                g.plot_line(ts, ys, label=name)
        errors[name] = {"errors": errs,
                        "order": float(np.log2(errs[0] / errs[1]))}
    g.plot_line(np.linspace(0, t1, 200), analytic(np.linspace(0, t1, 200)),
                label="analytic", lw=1.0)
    g.save(os.path.join(outdir, "ode.png"))

    with open(os.path.join(outdir, "ode.json"), "w") as fjson:
        json.dump(errors, fjson, indent=2)
    print(json.dumps(errors, indent=2))
    return errors
