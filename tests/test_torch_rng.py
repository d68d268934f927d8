"""The port's counter-based samplers against the JAX reference: every draw
must be bit-exact over a grid of (pixel, sample, dim), including Sobol'
dims in the committed tail (38..71) and dims past the table (which wrap)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from computational_ray_tracer_tpu.ops import rng as jrng
from computational_ray_tracer_tpu_torch.ops import rng as trng

PIXELS = np.random.default_rng(0).integers(
    0, 2 ** 32, size=400, dtype=np.uint64).astype(np.uint32)
DIMS = [0, 1, 5, 13, 36, 37, 38, 50, 70, 71, 72, 75, 141]


def _t(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def test_sobol_matrices_identical():
    assert trng.SOBOL_MATRICES.dtype == np.uint32
    np.testing.assert_array_equal(trng.SOBOL_MATRICES, jrng.SOBOL_MATRICES)


def test_hash_and_mix_bit_exact():
    a = PIXELS
    b = PIXELS[::-1].copy()
    ref_mix = np.asarray(jax.jit(jrng.mix_bits)(a))
    ref_hash = np.asarray(jax.jit(lambda x, y: jrng.hash_u32(7, x, y, 3))(a, b))
    np.testing.assert_array_equal(trng.mix_bits(_t(a)).numpy(),
                                  ref_mix.astype(np.int64))
    np.testing.assert_array_equal(trng.hash_u32(7, _t(a), _t(b), 3).numpy(),
                                  ref_hash.astype(np.int64))
    # scalar-only arguments stay Python ints with the same value
    assert trng.hash_u32(1, 2, 3) == int(jrng.hash_u32(1, 2, 3))


@pytest.mark.parametrize("n", [1, 7, 12, 32, 100])
def test_permutation_element_bit_exact(n):
    i = np.arange(n, dtype=np.uint32)
    p = PIXELS[:n]
    ref = np.asarray(jax.jit(lambda i_, p_: jrng.permutation_element(
        i_, n, p_))(i, p))
    got = trng.permutation_element(_t(i), n, _t(p)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert sorted(trng.permutation_element(_t(i), n, 12345).tolist()) == \
        list(range(n))


@pytest.mark.parametrize("kind,spp", [("independent", None), ("sobol", None),
                                      ("sobol", 32), ("sobol", 12)])
def test_draws_bit_exact(kind, spp):
    if kind == "independent":
        f1 = lambda p, s, d: jrng.independent_1d(11, p, s, d)
        f2 = lambda p, s, d: jrng.independent_2d(11, p, s, d)
        g1 = lambda p, s, d: trng.independent_1d(11, p, s, d)
        g2 = lambda p, s, d: trng.independent_2d(11, p, s, d)
    else:
        f1 = lambda p, s, d: jrng.sobol_owen_1d(11, p, s, d, spp=spp)
        f2 = lambda p, s, d: jrng.sobol_owen_2d(11, p, s, d, spp=spp)
        g1 = lambda p, s, d: trng.sobol_owen_1d(11, p, s, d, spp=spp)
        g2 = lambda p, s, d: trng.sobol_owen_2d(11, p, s, d, spp=spp)
    f1, f2 = jax.jit(f1), jax.jit(f2)
    samples = [0, 1, 5, 11] if spp else [0, 1, 5, 11, 1000, 2 ** 31 + 3]
    for s in samples:
        for d in DIMS:
            ref1 = np.asarray(f1(PIXELS, jnp.uint32(s), jnp.uint32(d)))
            ref2 = np.asarray(f2(PIXELS, jnp.uint32(s), jnp.uint32(d)))
            np.testing.assert_array_equal(g1(_t(PIXELS), s, d).numpy(), ref1,
                                          err_msg=f"1d s={s} d={d}")
            np.testing.assert_array_equal(g2(_t(PIXELS), s, d).numpy(), ref2,
                                          err_msg=f"2d s={s} d={d}")


def test_pixel_ids_cast_at_the_boundary():
    """int64 pixel ids from torch.arange hash as the reference's uint32."""
    pix = torch.arange(1000)
    ref = np.asarray(jax.jit(lambda p: jrng.sobol_owen_2d(0, p, 3, 9, spp=16))(
        jnp.arange(1000, dtype=jnp.uint32)))
    np.testing.assert_array_equal(
        trng.sobol_owen_2d(0, pix, 3, 9, spp=16).numpy(), ref)
