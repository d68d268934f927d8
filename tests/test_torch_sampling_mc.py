"""The port's samplers, Monte Carlo estimators, the rest of its RNG module
and its copy of ``sobol_quality`` against the JAX reference on the same
numpy-seeded inputs.

Tolerances: indices, alias tables, histogram counts and 32-bit words
exactly; element-wise float32 warps, pdfs and inverses rtol 1e-5 / atol
1e-6 (transcendentals from two libraries); the estimators' reductions in
another order, also rtol 1e-5. ``rejection_sample_1d`` takes a
``torch.Generator`` where the reference takes a key, so its draws differ:
both are held to the target density by a chi-square test.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computational_ray_tracer_tpu.ops import montecarlo as jmc
from computational_ray_tracer_tpu.ops import rng as jrng
from computational_ray_tracer_tpu.ops import sampling as jsmp
from computational_ray_tracer_tpu.ops import sobol_quality as jsq
from computational_ray_tracer_tpu_torch.ops import montecarlo as tmc
from computational_ray_tracer_tpu_torch.ops import rng as trng
from computational_ray_tracer_tpu_torch.ops import sampling as tsmp
from computational_ray_tracer_tpu_torch.ops import sobol_quality as tsq

RNG = np.random.default_rng(21)
J = jnp.asarray
T = lambda a: torch.tensor(np.asarray(a))
N = 2000
U = RNG.uniform(0, 1, N).astype(np.float32)
U2 = RNG.uniform(0, 1, (N, 2)).astype(np.float32)
X = RNG.uniform(-3, 3, N).astype(np.float32)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def both(name, *args):
    """(port, reference) of sampling.<name> on the same inputs."""
    t = getattr(tsmp, name)(*[T(a) if isinstance(a, np.ndarray) else a
                              for a in args])
    j = getattr(jsmp, name)(*[J(a) if isinstance(a, np.ndarray) else a
                              for a in args])
    return t, j


CASES_1D = [
    ("linear_pdf", (U, 0.5, 2.0)), ("sample_linear", (U, 0.5, 2.0)),
    ("sample_linear", (U, 0.0, 1.0)), ("invert_linear_sample", (U, 0.5, 2.0)),
    ("tent_pdf", (X, 2.0)), ("sample_tent", (U, 2.0)),
    ("invert_tent_sample", (X, 2.5)),
    ("exponential_pdf", (X, 1.5)), ("sample_exponential", (U, 1.5)),
    ("invert_exponential_sample", (np.abs(X), 1.5)),
    ("normal_pdf", (X, 0.3, 1.7)), ("sample_normal", (U, 0.3, 1.7)),
    ("invert_normal_sample", (X, 0.3, 1.7)),
    ("logistic_pdf", (X, 0.7)),
    ("sample_logistic", (np.clip(U, 1e-6, 1 - 1e-6), 0.7)),
    ("invert_logistic_sample", (X, 0.7)),
    ("cosine_hemisphere_pdf", (U,)),
]
W4 = RNG.uniform(0, 2, (N, 4)).astype(np.float32)
W4[::5] = 0.0
DIRS = RNG.normal(0, 1, (N, 3)).astype(np.float32)
DIRS /= np.linalg.norm(DIRS, axis=1, keepdims=True)
CASES_2D = [
    ("bilinear_pdf", (U2, W4)), ("sample_bilinear", (U2, W4 + 0.1)),
    ("invert_bilinear_sample", (U2, W4 + 0.1)),
    ("sample_uniform_disk_polar", (U2, 1.5)),
    ("sample_uniform_disk_concentric", (U2, 1.5)),
    ("sample_uniform_hemisphere", (U2,)),
    ("invert_uniform_hemisphere_sample", (DIRS,)),
    ("sample_uniform_sphere", (U2,)),
    ("invert_uniform_sphere_sample", (DIRS,)),
    ("sample_cosine_hemisphere", (U2,)),
    ("sample_uniform_cone", (U2, 0.8)),
]


@pytest.mark.parametrize("name, args", CASES_1D + CASES_2D,
                         ids=[c[0] for c in CASES_1D + CASES_2D])
def test_elementwise_warps_pdfs_inverses(name, args):
    t, j = both(name, *args)
    close(t, j)


def test_constant_pdfs():
    for name in ("uniform_hemisphere_pdf", "uniform_sphere_pdf"):
        assert getattr(tsmp, name)() == pytest.approx(getattr(jsmp, name)())
    assert tsmp.uniform_cone_pdf(0.8) == pytest.approx(
        float(jsmp.uniform_cone_pdf(0.8)))
    for name in ("INV_PI", "INV_2PI", "INV_4PI"):
        assert getattr(tsmp, name) == getattr(jsmp, name)


def test_sample_discrete():
    w = RNG.uniform(0, 1, (N, 6)).astype(np.float32)
    w[::4, 2] = 0.0
    for u in (U, U[:, None]):
        ti, tp, tu = tsmp.sample_discrete(T(u), T(w))
        ji, jp, ju = jsmp.sample_discrete(J(u), J(w))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        close(tp, jp)
        close(tu, ju)


def test_alias_table():
    w = RNG.uniform(0, 1, 37)
    w[5] = 0.0
    w[11] = 9.0
    a = jsmp.AliasTable.build(w)
    b = tsmp.AliasTable.build(w, device="cpu")
    np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
    np.testing.assert_array_equal(b.alias.numpy(), np.asarray(a.alias))
    np.testing.assert_array_equal(b.pmf.numpy(), np.asarray(a.pmf))
    ti, tp = b.sample(T(U))
    ji, jp = a.sample(J(U))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_normalize_and_tabulated_distribution():
    close(tsmp.normalize_pdf(lambda x: torch.exp(-x * x), -2.0, 3.0,
                             device="cpu"),
          jsmp.normalize_pdf(lambda x: jnp.exp(-x * x), -2.0, 3.0))
    pairs = [
        (jsmp.TabulatedDistribution1D.from_function(
            lambda x: x * x + 0.25 * x, -1.0, 2.0, 300),
         tsmp.TabulatedDistribution1D.from_function(
            lambda x: x * x + 0.25 * x, -1.0, 2.0, 300, device="cpu"))]
    xs = np.linspace(0.0, 4.0, 97)
    fx = np.abs(np.sin(3 * xs)) + 0.1
    pairs.append((jsmp.TabulatedDistribution1D.from_table(xs, fx),
                  tsmp.TabulatedDistribution1D.from_table(xs, fx,
                                                          device="cpu")))
    for a, b in pairs:
        for k in ("x", "pdf", "cdf"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)))
        for got, want in zip(b.sample(T(U)), a.sample(J(U))):
            close(got, want)
        q = RNG.uniform(-1.5, 4.5, 500).astype(np.float32)
        close(b.pdf_at(T(q)), a.pdf_at(J(q)))


def test_rejection_sample_1d_matches_target():
    f = lambda x: 1.0 + (torch.sin(x) if isinstance(x, torch.Tensor)
                         else jnp.sin(x))
    cdf = lambda x: (x + 1.0 - math.cos(x)) / (math.pi + 2.0)
    n = 20000
    got = tsmp.rejection_sample_1d(f, torch.Generator().manual_seed(3), 0.0,
                                   math.pi, 2.0, n)
    again = tsmp.rejection_sample_1d(f, torch.Generator().manual_seed(3),
                                     0.0, math.pi, 2.0, n)
    ref = jsmp.rejection_sample_1d(f, jax.random.PRNGKey(3), 0.0, math.pi,
                                   2.0, n)
    assert got.shape == (n,) and torch.equal(got, again)
    assert float(got.min()) >= 0.0 and float(got.max()) <= math.pi
    # chi-square with 31 dof: P(> 61.1) = 0.001
    for s in (got.numpy(), np.asarray(ref)):
        stat, dof = tsmp.chi_square_statistic(s, cdf, 0.0, math.pi)
        assert dof == 32 and stat < 61.1, stat


def test_histogram_and_chi_square():
    s = np.concatenate([RNG.normal(0, 1, 5000), [-4.0, 4.0, 1.0, -1.0, 9.0]]
                       ).astype(np.float32)
    tc, td = tsmp.histogram_pdf(T(s), -4.0, 4.0, bins=64)
    jc, jd = jsmp.histogram_pdf(J(s), -4.0, 4.0, bins=64)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    close(tc, jc)
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    assert tsmp.chi_square_statistic(s, cdf, -4.0, 4.0) == \
        jsmp.chi_square_statistic(s, cdf, -4.0, 4.0)


# ---------------------------------------------------------------------------
# montecarlo
# ---------------------------------------------------------------------------

def test_estimators():
    xs = RNG.uniform(5.0, 12.0, 50000).astype(np.float32)
    a = jmc.uniform_estimator(lambda x: jnp.cos(x) + 5.0, J(xs), 5.0, 12.0)
    b = tmc.uniform_estimator(lambda x: torch.cos(x) + 5.0, T(xs), 5.0, 12.0)
    pdf = RNG.uniform(0.05, 0.2, 50000).astype(np.float32)
    c = jmc.distribution_estimator(lambda x: jnp.cos(x) + 5.0, J(xs),
                                   J(pdf), cost=2.0, delta=0.1)
    d = tmc.distribution_estimator(lambda x: torch.cos(x) + 5.0, T(xs),
                                   T(pdf), cost=2.0, delta=0.1)
    for want, got in ((a, b), (c, d)):
        for k in ("estimate", "variance", "sample_variance", "efficiency",
                  "chebyshev_bound"):
            close(getattr(got, k), getattr(want, k))
    nf, ng = 1.0, 2.0
    fp, gp = RNG.uniform(0, 3, (2, N)).astype(np.float32)
    fp[::6] = 0.0
    gp[::6] = 0.0
    for name in ("balance_heuristic", "power_heuristic"):
        close(getattr(tmc, name)(nf, T(fp), ng, T(gp)),
              getattr(jmc, name)(nf, J(fp), ng, J(gp)))


# ---------------------------------------------------------------------------
# rng and sobol_quality
# ---------------------------------------------------------------------------

def test_binary_permute_scramble_and_hash_continuation():
    v = RNG.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    seeds = RNG.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    got = trng.binary_permute_scramble(T(v.astype(np.int64)),
                                       T(seeds.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy().astype(np.uint32),
        np.asarray(jrng.binary_permute_scramble(J(v), J(seeds))))
    assert trng.binary_permute_scramble(7, 0xFFFFFFFF) == 0xFFFFFFF8
    px = T(v.astype(np.int64))
    whole = trng.hash_u32(5, px, 17, 3)
    np.testing.assert_array_equal(
        trng.hash_u32(17, 3, h=trng.hash_u32(5, px)).numpy(), whole.numpy())
    np.testing.assert_array_equal(
        whole.numpy().astype(np.uint32),
        np.asarray(jrng.hash_u32(5, J(v), 17, 3)))


def test_primitive_polys_and_sobol_fallback_dims():
    assert trng._primitive_polys_gf2(120) == jrng._primitive_polys_gf2(120)
    # dims past the committed tail take the reference's fallback initials
    np.testing.assert_array_equal(trng._sobol_matrices(130),
                                  jrng._sobol_matrices(130))


def test_sobol_quality_copy():
    s, a, m = 5, 13, [1, 1, 1, 3, 11]
    v = tsq.expand_direction_numbers(s, a, m)
    assert v == jsq.expand_direction_numbers(s, a, m)
    assert tsq.vdc_direction_numbers() == jsq.vdc_direction_numbers()
    rows = tsq.row_masks(v, 12)
    assert rows == jsq.row_masks(v, 12)
    r0 = tsq.row_masks(tsq.vdc_direction_numbers(), 12)
    assert tsq.gf2_rank(rows + r0) == jsq.gf2_rank(rows + r0)
    assert tsq.pair_t_value(r0, rows, 12) == jsq.pair_t_value(r0, rows, 12)
    assert tsq.dim1_t_value(rows, 12) == jsq.dim1_t_value(rows, 12) == 0
    assert tsq.diag_deficiency(r0, rows, 12) == jsq.diag_deficiency(r0, rows,
                                                                     12)
    prev = [r0, rows]
    assert tsq.cbc_search_dim(prev, 7, 1, n_candidates=8, seed=3) == \
        jsq.cbc_search_dim(prev, 7, 1, n_candidates=8, seed=3)
