"""The port's global Sobol' sampler and host PCG32 (``ops/rng.py``) against
the JAX package's, bit for bit, the counterparts of the four tests of
``tests/test_sobol_global.py``, and a 32x32 path/MIS sobol_global pass
against the JAX render_pass."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.ops import rng as jrng
from computational_ray_tracer_tpu_torch import convert
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.ops import camera as tcam
from computational_ray_tracer_tpu_torch.ops import rng as trng

MS = [0, 1, 3, 5, 9]


def _frames(m):
    """Frames 0, 1, 7 and the last two that fit 32 bits at scale 2^m."""
    top = 1 << (32 - 2 * m)
    return [0, 1, 7, top - 2, top - 1]


def _pixels(m, n=400, seed=0):
    gen = np.random.default_rng(seed + m)
    px = gen.integers(0, 1 << m, n).astype(np.uint32)
    py = gen.integers(0, 1 << m, n).astype(np.uint32)
    return px, py, torch.as_tensor(px.astype(np.int64)), \
        torch.as_tensor(py.astype(np.int64))


def _same(jax_out, port_out):
    """Equal bits; at m = 0 the reference returns one value for every
    pixel (its index is the frame), the port a value per pixel."""
    a = np.asarray(jax_out)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    np.testing.assert_array_equal(port_out.numpy(),
                                  np.broadcast_to(a, port_out.shape))


@pytest.mark.parametrize("m", MS)
def test_interval_to_index_matches_jax(m):
    """The host GF(2) inverse and the index of each (pixel, frame), frames
    up to 2^(32-2m) - 1, where a shift kept in int64 would show."""
    np.testing.assert_array_equal(trng._global_sobol_cols(m),
                                  jrng._global_sobol_cols(m))
    px, py, tpx, tpy = _pixels(m)
    for frame in _frames(m):
        _same(jrng.sobol_global_index(jnp.asarray(px), jnp.asarray(py),
                                      jnp.uint32(frame), m),
              trng.sobol_global_index(tpx, tpy, frame, m))


@pytest.mark.parametrize("m", MS)
def test_global_draws_match_jax(m):
    """pixel2d, 1d and 2d draws bit for bit, for dims before and past the
    72-dimension wrap of the direction table."""
    px, py, tpx, tpy = _pixels(m, seed=1)
    jpx, jpy = jnp.asarray(px), jnp.asarray(py)
    for frame in _frames(m)[::2]:
        jf = jnp.uint32(frame)
        _same(jrng.sobol_global_pixel2d(3, jpx, jpy, jf, m),
              trng.sobol_global_pixel2d(3, tpx, tpy, frame, m))
        for dim in (0, 1, 5, 68, 69, 70, 71, 140, 300):
            _same(jrng.sobol_global_1d(3, jpx, jpy, jf, dim, m),
                  trng.sobol_global_1d(3, tpx, tpy, frame, dim, m))
            _same(jrng.sobol_global_2d(3, jpx, jpy, jf, dim, m),
                  trng.sobol_global_2d(3, tpx, tpy, frame, dim, m))


@pytest.mark.parametrize("seq,offset", [(0, None), (1, 0), (7, 123456789),
                                        (2 ** 40 + 3, 2 ** 63 + 5)])
def test_pcg32_matches_jax(seq, offset):
    """The same u32 and float sequence after set_sequence, after advance
    and after advancing back by the two's complement."""
    a, b = jrng.PCG32(seq, offset), trng.PCG32(seq, offset)
    for delta in (0, 1, 1000, 2 ** 40 + 17, 2 ** 64 - 1001):
        a.advance(delta)
        b.advance(delta)
        assert [int(a.uniform_u32()) for _ in range(8)] == \
            [int(b.uniform_u32()) for _ in range(8)]
        assert a.uniform_float() == b.uniform_float()
        assert (a.state, a.inc) == (b.state, b.inc)
    c = trng.PCG32()
    assert int(c.uniform_u32()) == int(jrng.PCG32().uniform_u32())


def _host_sobol(index, dim):
    v = np.uint32(0)
    k = 0
    while index:
        if index & 1:
            v ^= trng.SOBOL_MATRICES[dim, k]
        index >>= 1
        k += 1
    return int(v)


def _grid(m):
    res = 1 << m
    px, py = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    return torch.as_tensor(px.ravel()), torch.as_tensor(py.ravel())


@pytest.mark.parametrize("m", [1, 2, 3])
def test_interval_to_index_lands_in_pixel(m):
    """Every pixel's mapped point has dims 0/1 inside that pixel."""
    px, py = _grid(m)
    for frame in (0, 1, 2, 5, 9):
        idx = trng.sobol_global_index(px, py, frame, m).tolist()
        for i, ix in enumerate(idx):
            assert _host_sobol(ix, 0) >> (32 - m) == int(px[i])
            assert _host_sobol(ix, 1) >> (32 - m) == int(py[i])


def test_interval_to_index_is_partition():
    """Frame f's indices over all pixels are exactly f*4^m .. (f+1)*4^m-1."""
    m = 3
    px, py = _grid(m)
    for frame in (0, 3):
        idx = np.sort(trng.sobol_global_index(px, py, frame, m).numpy())
        lo = frame << (2 * m)
        np.testing.assert_array_equal(idx, np.arange(lo, lo + 64))


def test_global_beats_padded_on_image_integral():
    """The image mean of a smooth 4D integrand: the global sequence beats
    the padded per-pixel Sobol' at spp 4 and 16."""
    m = 4
    res = 1 << m
    pixel = torch.arange(res * res)
    px, py = pixel % res, pixel // res
    pxy = torch.stack([px, py], dim=-1).to(torch.float32)
    analytic = 0.25 + (2.0 / np.pi) ** 2

    def integrand(xy, uv):
        sin = torch.sin(np.pi * uv)
        return xy[..., 0] * xy[..., 1] + sin[..., 0] * sin[..., 1]

    def estimate(kind, spp, seed):
        total = 0.0
        for s in range(spp):
            if kind == "global":
                f = trng.sobol_global_pixel2d(seed, px, py, s, m)
                uv = trng.sobol_global_2d(seed, px, py, s, 3, m)
            else:
                f = trng.sobol_owen_2d(seed, pixel, s, 1, spp=spp)
                uv = trng.sobol_owen_2d(seed, pixel, s, 3, spp=spp)
            total += float(integrand((pxy + f) / res, uv).mean())
        return total / spp

    for spp in (4, 16):
        err_g = np.mean([abs(estimate("global", spp, s) - analytic)
                         for s in range(8)])
        err_p = np.mean([abs(estimate("padded", spp, s) - analytic)
                         for s in range(8)])
        assert err_g < err_p, (spp, err_g, err_p)


def _sphere_scene():
    from computational_ray_tracer_tpu.models.scene import Scene as JScene
    from test_torch_render import export_scene
    jscene = JScene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.4, 0.3)}],
        lights=[{"kind": "point", "position": (2.0, 3.0, -2.0),
                 "spd_named": "stdillum-D65", "scale": 15.0}],
        spheres=[{"radius": 1.0, "material": 0}])
    return jscene, convert.scene_from_numpy(export_scene(jscene), "cpu")


def _global_cfg(mod, res, spp):
    return mod.RenderConfig(
        resolution=(res, res),
        sampler=mod.SamplerConfig(kind="sobol_global", spp=spp),
        integrator="path", max_depth=3)


def test_sobol_global_render_smoke():
    """RenderConfig derives the image geometry and the sampler renders a
    finite, lit image."""
    _, scene = _sphere_scene()
    camera = tcam.PerspectiveCamera.create((0, 0, -4), (16, 16), fov_y=40.0,
                                           look_at=(0, 0, 0))
    cfg = _global_cfg(tinteg, 16, 4)
    assert cfg.sampler.width == 16 and cfg.sampler.m == 4
    film, sensor = tinteg.render(scene, camera, cfg)
    img = film.resolve(sensor, to_srgb=False, clip=False).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.001
    with pytest.raises(ValueError, match="32 bits"):
        _global_cfg(tinteg, 1 << 16, 2)


@pytest.mark.parametrize("sample_idx", [0, 3])
def test_sobol_global_pass_matches_jax(sample_idx):
    """One 32x32 path/MIS pass with sobol_global against the JAX
    render_pass on bit-identical scene parameters, atol 2e-3*max."""
    from computational_ray_tracer_tpu.ops import camera as jcam
    jscene, tscene = _sphere_scene()
    jcfg, tcfg = _global_cfg(jinteg, 32, 4), _global_cfg(tinteg, 32, 4)
    assert dataclasses.astuple(tcfg.sampler) == \
        dataclasses.astuple(jcfg.sampler)
    view = dict(fov_y=40.0, look_at=(0, 0, 0))
    rj, wj = jinteg.render_pass(
        jscene, jcam.PerspectiveCamera.create((0, 0, -4), (32, 32), **view),
        jcfg, jinteg.make_filter(jcfg), jinteg.make_sensor(jcfg),
        jnp.uint32(sample_idx))
    rt, wt = tinteg.render_pass(
        tscene, tcam.PerspectiveCamera.create((0, 0, -4), (32, 32), **view),
        tcfg, tinteg.make_filter(tcfg), tinteg.make_sensor(tcfg),
        sample_idx)
    rj = np.asarray(rj)
    assert rj.max() > 0
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                               atol=2e-3 * float(rj.max()))
