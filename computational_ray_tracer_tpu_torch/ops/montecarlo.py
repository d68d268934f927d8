"""Monte Carlo estimators and MIS weights
(``computational_ray_tracer_tpu/ops/montecarlo.py``): the uniform
estimator (b-a)/N sum f(X_i) and the importance-sampled estimator
1/N sum f(X_i)/p(X_i), each with its variance, efficiency and Chebyshev
bound, as reductions over the whole batch of samples.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EstimatorResult:
    estimate: torch.Tensor
    variance: torch.Tensor          # variance of the estimator (sigma^2/N)
    sample_variance: torch.Tensor   # variance of one sample's contribution
    efficiency: torch.Tensor        # 1 / (variance * cost)
    chebyshev_bound: torch.Tensor   # eps with P(|F - E| >= eps) <= delta

    @staticmethod
    def _from_contributions(contrib, cost, delta):
        n = contrib.shape[-1]
        svar = torch.var(contrib, dim=-1, correction=1)
        var = svar / n
        return EstimatorResult(
            torch.mean(contrib, dim=-1), var, svar,
            1.0 / torch.clamp(var * cost, min=1e-30),
            torch.sqrt(var / delta))


def uniform_estimator(f, samples, a, b, cost=1.0, delta=0.05):
    """(b-a)/N sum f(X_i) for X_i uniform on [a, b]."""
    return EstimatorResult._from_contributions((b - a) * f(samples), cost,
                                               delta)


def distribution_estimator(f, samples, pdf_values, cost=1.0, delta=0.05):
    """1/N sum f(X_i)/p(X_i), the importance-sampled estimator."""
    return EstimatorResult._from_contributions(
        f(samples) / torch.clamp(pdf_values, min=1e-30), cost, delta)


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS balance heuristic."""
    return (nf * f_pdf) / torch.clamp(nf * f_pdf + ng * g_pdf, min=1e-30)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (beta = 2)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-30)
