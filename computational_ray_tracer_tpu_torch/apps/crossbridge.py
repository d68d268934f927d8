"""Muscle crossbridge app (``computational_ray_tracer_tpu/apps/
crossbridge.py``): 10,000 bridges attaching at 14/s and detaching at
126/s, their attached fraction over 4,000 steps against the steady state
f/(f+g), and the force-velocity curve over 17 sliding velocities
(2,000 steps each, one batch). Report: ``crossbridge.json``."""

from __future__ import annotations

import json
import os

import numpy as np


def main(outdir="out", n_steps=4000, seed=0, device="cuda"):
    from computational_ray_tracer_tpu_torch.models import simulation as sim
    from computational_ray_tracer_tpu_torch.utils import plot

    os.makedirs(outdir, exist_ok=True)
    cfg = sim.CrossbridgeConfig(seed=seed)
    res = sim.simulate_crossbridges(cfg, n_steps, device=device)
    attached = res["n_attached"].cpu().numpy()
    force = res["force"].cpu().numpy()
    ts = np.arange(n_steps) * cfg.dt
    ss = sim.steady_state_attachment_fraction(cfg)

    g = plot.Graph2D(title="Crossbridge attachment", xlabel="t [s]",
                     ylabel="fraction attached")
    g.plot_line(ts, attached / cfg.n_bridges, label="simulated")
    g.plot_line(ts, np.full(len(ts), ss), label="steady state")
    g.save(os.path.join(outdir, "crossbridge_attach.png"))

    vels = np.linspace(0.0, 8.0, 17)
    forces = sim.force_velocity_curve(cfg, vels, device=device)
    g2 = plot.Graph2D(title="Force-velocity", xlabel="shortening velocity",
                      ylabel="mean force")
    g2.plot_line(vels, forces, label="F(v)")
    g2.save(os.path.join(outdir, "force_velocity.png"))

    report = {
        "n_bridges": cfg.n_bridges,
        "attach_rate": cfg.attach_rate,
        "detach_rate": cfg.detach_rate,
        "steady_state_fraction": float(ss),
        "simulated_final_fraction": float(attached[-100:].mean()
                                          / cfg.n_bridges),
        "mean_force_tail": float(force[-100:].mean()),
        "fv_monotone_decreasing": bool(np.all(np.diff(forces) <= 1e-3)),
    }
    with open(os.path.join(outdir, "crossbridge.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report
