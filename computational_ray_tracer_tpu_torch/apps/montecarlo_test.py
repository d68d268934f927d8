"""Monte Carlo estimator app (``computational_ray_tracer_tpu/apps/
montecarlo_test.py``): expected value, variance, efficiency and the
Chebyshev bound of the uniform and of a linear importance-sampled
estimator of the integral of cos x + 5 over [5, 12], against the analytic
35.4223513567. Report: ``montecarlo.json``."""

from __future__ import annotations

import json
import os

ANALYTIC = 35.4223513567


def main(outdir="out", n=200_000, device="cuda"):
    import torch
    from computational_ray_tracer_tpu_torch.apps import uniform
    from computational_ray_tracer_tpu_torch.ops import montecarlo as mc
    from computational_ray_tracer_tpu_torch.ops import sampling as smp

    os.makedirs(outdir, exist_ok=True)
    f = lambda x: torch.cos(x) + 5.0
    a, b = 5.0, 12.0
    report = {"analytic": ANALYTIC}

    res = mc.uniform_estimator(f, uniform(0, (n,), device, a, b), a, b)
    report["uniform"] = {
        "estimate": float(res.estimate),
        "abs_error": abs(float(res.estimate) - ANALYTIC),
        "variance": float(res.variance),
        "efficiency": float(res.efficiency),
        "chebyshev_95": float(res.chebyshev_bound),
    }

    # importance sampling with a linear pdf rising over [a, b]
    t = smp.sample_linear(uniform(1, (n,), device), 0.8, 1.2)
    pdf = smp.linear_pdf(t, 0.8, 1.2) / (b - a)
    res_i = mc.distribution_estimator(f, a + t * (b - a), pdf)
    report["importance_linear"] = {
        "estimate": float(res_i.estimate),
        "abs_error": abs(float(res_i.estimate) - ANALYTIC),
        "variance": float(res_i.variance),
        "efficiency": float(res_i.efficiency),
    }

    with open(os.path.join(outdir, "montecarlo.json"), "w") as fjson:
        json.dump(report, fjson, indent=2)
    print(json.dumps(report, indent=2))
    return report
