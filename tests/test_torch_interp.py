"""The port's dense-spectrum interpolation (the CUDA interp kernel's plain
version and ``spectrum.sample_dense_multi``), stratified sampler, filters,
backface culling and native octree builder against the JAX reference on the
same inputs; and, on a CUDA machine only, the kernel against its plain
version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from computational_ray_tracer_tpu import native as jnative
from computational_ray_tracer_tpu.ops import filters as jflt
from computational_ray_tracer_tpu.ops import octree as joct
from computational_ray_tracer_tpu.ops import pallas_interp as jpi
from computational_ray_tracer_tpu.ops import rng as jrng
from computational_ray_tracer_tpu.ops import spectrum as jspec
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu_torch.ops import filters as tflt
from computational_ray_tracer_tpu_torch.ops import interp_kernel as ik
from computational_ray_tracer_tpu_torch.ops import octree as toct
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.ops import rng as trng
from computational_ray_tracer_tpu_torch.ops import spectrum as tspec
from computational_ray_tracer_tpu_torch.ops import triangle as ttri

T = lambda a: torch.tensor(np.asarray(a))
TREE_FIELDS = ("node_lo", "node_hi", "node_child0", "node_leaf_id",
               "leaf_tris", "leaf_counts")


def _interp_inputs():
    """The inputs of tests/test_mxu_interp.py's Pallas interp test."""
    rng = np.random.default_rng(3)
    tables = rng.normal(size=(471, 15)).astype(np.float32)
    i0 = rng.integers(0, 469, size=(4096,)).astype(np.int32)
    w = rng.uniform(0, 1, size=(4096,)).astype(np.float32)
    return tables, i0, w


def test_dense_interp_plain_matches_pallas_and_numpy():
    """The plain version against the Pallas kernel in interpret mode (its
    own gate, rtol/atol 2e-5: the TPU kernel's bf16 hi/lo split is exact to
    about 2^-18) and against a numpy lerp, bit for bit."""
    tables, i0, w = _interp_inputs()
    w[:7] = 0.0
    w[7:14] = 1.0
    ref = np.asarray(jpi.dense_interp_pallas(
        jnp.asarray(tables), jnp.asarray(i0), jnp.asarray(w), interpret=True))
    got = ik.dense_interp_plain(T(tables), T(i0), T(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    lerp = tables[i0] * (1 - w[:, None]) + tables[i0 + 1] * w[:, None]
    np.testing.assert_array_equal(got, lerp)


def test_sample_dense_multi_matches_jax_pallas_route(monkeypatch):
    """The port's sample_dense_multi against the JAX function routed
    through its Pallas kernel (forced on as tests/test_mxu_interp.py's
    force_mxu fixture does, plus CRT_PALLAS_INTERP=1; interpret mode off
    the TPU), including wavelengths outside [360, 830]."""
    monkeypatch.setattr(jspec, "_use_mxu_interp", lambda: True)
    monkeypatch.setenv("CRT_PALLAS_INTERP", "1")
    rng = np.random.default_rng(8)
    tables = rng.normal(size=(471, 5)).astype(np.float32)
    lam = rng.uniform(350, 840, size=(512, 8)).astype(np.float32)
    ref = np.asarray(jspec.sample_dense_multi(jnp.asarray(tables),
                                              jnp.asarray(lam)))
    got = tspec.sample_dense_multi(T(tables), T(lam)).numpy()
    assert got.shape == (512, 8, 5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    outside = (lam < 360) | (lam > 830)
    assert outside.any() and (got[outside] == 0).all()


def test_interp_wrapper_runs_plain_on_cpu_and_counts_only_launches():
    tables, i0, w = _interp_inputs()
    before = ik.LAUNCHES
    out = ik.dense_interp(T(tables), T(i0), T(w))
    assert ik.LAUNCHES == before
    assert torch.equal(out, ik.dense_interp_plain(T(tables), T(i0), T(w)))
    k = tables.shape[0]
    wild = T(i0).clone()
    wild[:3] = torch.tensor([-5, k - 1, k + 7], dtype=wild.dtype)
    assert torch.equal(ik.dense_interp(T(tables), wild, T(w)),
                       ik.dense_interp_plain(T(tables), wild.clamp(0, k - 2),
                                             T(w)))
    meta = [torch.tensor(x, device="meta") for x in (tables, i0, w)]
    with pytest.raises(ValueError):
        ik.dense_interp(*meta)
    spd = tspec.DenselySampledSpectrum.from_named("stdillum-F1")
    lam = torch.tensor([[400.0, 555.5, 900.0]])
    want = jspec.DenselySampledSpectrum.from_named("stdillum-F1")(
        jnp.asarray(lam.numpy()))
    np.testing.assert_array_equal(spd(lam).numpy(), np.asarray(want))


def test_dense_interp_kernel_matches_plain_on_cuda():
    """Needs a CUDA card and nvcc (chip_smoke.py runs the full-size checks
    on the GPU): bitwise, with a shared-memory table (C = 5) and a table
    read through the read-only cache (C = 128), indices outside [0, K-2]
    clamped alike."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    rng = np.random.default_rng(9)
    for c in (5, 128):
        tables = torch.tensor(rng.normal(size=(471, c)).astype(np.float32),
                              device="cuda")
        i0 = torch.tensor(rng.integers(0, 470, 65536).astype(np.int32),
                          device="cuda")
        w = torch.tensor(rng.uniform(0, 1, 65536).astype(np.float32),
                         device="cuda")
        w[:100] = 0.0
        w[100:200] = 1.0
        i0[200:250] = -3
        i0[250:300] = 600
        before = ik.LAUNCHES
        k = ik.dense_interp(tables, i0, w)
        p = ik.dense_interp_plain(tables, i0, w)
        torch.cuda.synchronize()
        assert ik.LAUNCHES == before + 1
        assert torch.equal(k, p)


@pytest.mark.parametrize("kind", ["1d", "2d_2x2", "2d_3x5"])
@pytest.mark.parametrize("jitter", [True, False])
def test_stratified_matches_reference(kind, jitter):
    """Bit-exact with the reference for every sample index of the pass."""
    px = np.arange(3000, dtype=np.uint32)
    tp = torch.tensor(px.astype(np.int64))
    xs, ys = {"1d": (4, 4), "2d_2x2": (2, 2), "2d_3x5": (3, 5)}[kind]
    for s in range(xs * ys):
        if kind == "1d":
            ref = jrng.stratified_1d(0, jnp.asarray(px), jnp.uint32(s), 1,
                                     xs * ys, jitter)
            got = trng.stratified_1d(0, tp, s, 1, xs * ys, jitter)
        else:
            ref = jrng.stratified_2d(0, jnp.asarray(px), jnp.uint32(s), 3,
                                     xs, ys, jitter)
            got = trng.stratified_2d(0, tp, s, 3, xs, ys, jitter)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["box", "triangle", "gaussian"])
def test_filters_match_reference(name):
    rng = np.random.default_rng(10)
    u = rng.uniform(0, 1, (4000, 2)).astype(np.float32)
    u[:4] = [[0.0, 0.0], [0.5, 0.5], [0.9999999, 0.25], [0.4999, 0.5001]]
    p = rng.uniform(-0.8, 0.8, (4000, 2)).astype(np.float32)
    jf = jflt.FILTERS[name]((0.5, 0.5))
    tf = tflt.FILTERS[name]((0.5, 0.5))
    assert tf.integral == pytest.approx(jf.integral, rel=1e-12)
    for g, r in zip(tf.sample(T(u)), jf.sample(jnp.asarray(u))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(tf.evaluate(T(p)).numpy(),
                               np.asarray(jf.evaluate(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-7)


def _culled_stand_in():
    v, f, uv = jmesh_gen.dragon_stand_in(target_tris=6000)
    v = np.asarray(v, np.float32) * 5.0 + np.asarray([0, -40, 800],
                                                     np.float32)
    return v, f, uv


def test_backface_mask_and_pack_match_reference():
    """compute_backface_mask equals the reference's, and the packed octree
    with the mask equals the reference's packed arrays."""
    v, f, uv = _culled_stand_in()
    jmesh = jtri.MeshData.build(v, f, uvs=uv)
    tmesh = ttri.MeshData.build(v, f, uvs=uv)
    jmask = np.asarray(jtri.compute_backface_mask(jmesh, (0.0, 0.0, 1.0)))
    tmask = ttri.compute_backface_mask(tmesh, (0.0, 0.0, 1.0))
    assert 0.3 < jmask.mean() < 0.7
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    jtree, jp = joct.build_octree(jmesh, capacity=40, pack=True,
                                  tri_mask=jnp.asarray(jmask))
    tp = okern.pack_from_numpy(toct.build_octree(v, f, 40), tmesh, tmask)
    for name in ("nodes", "leaf_verts", "row_tri"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))


@pytest.mark.parametrize("subdiv,cap", [(3, 40), (4, 192)])
def test_native_builder_matches_numpy_and_reference(subdiv, cap):
    """The port's C++ tree against its NumPy tree and the reference's
    native builder (tests/test_native_octree.py's assertions), before the
    over-full-leaf split, and the split trees against the reference's."""
    v, f, uv = jmesh_gen.displaced_icosphere(subdiv)
    pos, idx = np.asarray(v, np.float32), np.asarray(f, np.int32)
    args = (pos, idx, cap, toct.MAX_DEPTH, toct.CHILD_PADDING_FRAC)
    t_cc = toct._build_octree_native(*args)
    t_np = toct._build_octree_numpy(*args)
    trees = [t_np]
    if jnative.load() is not None:
        trees.append(joct._build_octree_native(*args))
    for ref in trees:
        for k in ("node_child0", "node_leaf_id", "leaf_counts",
                  "leaf_tris"):
            np.testing.assert_array_equal(getattr(t_cc, k),
                                          np.asarray(getattr(ref, k)))
        for k in ("node_lo", "node_hi"):
            np.testing.assert_allclose(getattr(t_cc, k),
                                       np.asarray(getattr(ref, k)), rtol=0,
                                       atol=1e-6)
    built = toct.build_octree(v, f, cap)
    jtree = joct.build_octree(jtri.MeshData.build(v, f, uvs=uv),
                              capacity=cap)
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(built, k),
                                      np.asarray(getattr(jtree, k)))
    with pytest.raises(ValueError):
        toct.build_octree(v, f, cap, backend="auto")
