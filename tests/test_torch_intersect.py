"""The port's mesh intersection (plain version of the CUDA kernel) against
the JAX reference's jnp brute force and its Pallas kernel (interpret mode),
on the soup, Cornell and mask/t_max cases of tests/test_pallas_intersect.py
with that file's tolerances; sphere and surface parity; and, on a CUDA
machine only, the kernel against its plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from computational_ray_tracer_tpu.ops import pallas_intersect as pk
from computational_ray_tracer_tpu.ops import shapes as jshp
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu_torch.ops import mesh_intersect_kernel as mik
from computational_ray_tracer_tpu_torch.ops import shapes as tshp
from computational_ray_tracer_tpu_torch.ops import triangle as ttri
from computational_ray_tracer_tpu_torch.utils import mesh_gen as tmesh_gen


def _soup(n_rays, n_tris, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e1, base + e2], axis=0)
    idx = np.stack([np.arange(n_tris) + k * n_tris for k in range(3)],
                   axis=1).astype(np.int32)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos, idx, o, d


def _case(name):
    """(positions, indices, o, d, t_max, mask) of a reference test case."""
    if name == "soup":
        pos, idx, o, d = _soup(777, 450, 0)
        return pos, idx, o, d, np.full(777, np.inf, np.float32), None
    if name == "cornell":
        pos, idx, _, _, _ = jmesh_gen.cornell_box(2.0)
        rng = np.random.default_rng(3)
        o = rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
        d = rng.normal(0, 1, (512, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return pos, idx, o, d, np.full(512, np.inf, np.float32), None
    pos, idx, o, d = _soup(256, 100, 5)
    return (pos, idx, o, d, np.full(256, 1.5, np.float32),
            np.arange(100) % 2 == 0)


def _both(name):
    pos, idx, o, d, tm, mask = _case(name)
    jm = jtri.MeshData.build(pos, idx)
    tm_ = ttri.MeshData.build(pos, idx)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jm)
    jmask = None if mask is None else jnp.asarray(mask)
    targs = (torch.tensor(o), torch.tensor(d), torch.tensor(tm), tm_)
    tmask = None if mask is None else torch.tensor(mask)
    got = [x.numpy() for x in ttri.mesh_intersect_brute(*targs, tmask,
                                                         chunk=100)]
    return jargs, jmask, got, mask


def _assert_matches(ref, got, name, mask):
    """tests/test_pallas_intersect.py's gates."""
    t_ref, i_ref, b1_ref = (np.asarray(x) for x in ref[:3])
    t_got, i_got, b1_got = got[:3]
    h_ref, h_got = np.isfinite(t_ref), np.isfinite(t_got)
    if name == "cornell":
        np.testing.assert_array_equal(h_ref, h_got)
        assert h_ref.mean() > 0.5
    assert (h_ref == h_got).mean() > 0.995
    both = h_ref & h_got
    np.testing.assert_allclose(t_got[both], t_ref[both], rtol=2e-4, atol=2e-5)
    same = i_got[both] == i_ref[both]
    assert same.mean() > 0.99
    np.testing.assert_allclose(b1_got[both][same], b1_ref[both][same],
                               rtol=1e-3, atol=1e-4)
    if mask is not None:
        assert (t_got[h_got] <= 1.5 + 1e-5).all()
        assert mask[i_got[h_got]].all()
    # the port's miss convention (that of the Pallas wrapper)
    assert (i_got[~h_got] == -1).all() and (got[2][~h_got] == 0).all()


CASES = ["soup", "cornell", "tmax_mask"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jnp_brute(name):
    jargs, jmask, got, mask = _both(name)
    ref = jtri.mesh_intersect_brute(*jargs, tri_mask=jmask)
    _assert_matches(ref, got, name, mask)
    # Both use shapes.py's 4097 Dekker split in the same operation order, so
    # they agree bit for bit: t everywhere, and idx/b1/b2 where a ray hits
    # (on a miss the jnp version leaves idx 0 and unmasked barycentrics).
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    hit = np.isfinite(got[0])
    for g, r in zip(got[1:4], ref[1:4]):
        np.testing.assert_array_equal(g[hit], np.asarray(r)[hit])


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_interpret(name):
    jargs, jmask, got, mask = _both(name)
    ref = pk.mesh_intersect_pallas(*jargs, tri_mask=jmask, interpret=True)
    _assert_matches(ref, got, name, mask)


def test_chunking_and_anyhit_agree():
    pos, idx, o, d, tm, mask = _case("tmax_mask")
    mesh = ttri.MeshData.build(pos, idx)
    args = (torch.tensor(o), torch.tensor(d), torch.tensor(tm), mesh,
            torch.tensor(mask))
    a = ttri.mesh_intersect_brute(*args, chunk=7)
    b = ttri.mesh_intersect_brute(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ttri.mesh_anyhit_brute(*args), a[1] >= 0)
    assert (a[4] == 100).all()


def test_wrapper_runs_plain_on_cpu_and_counts_only_kernel_launches():
    pos, idx, o, d, tm, _ = _case("cornell")
    mesh = ttri.MeshData.build(pos, idx)
    before = mik.LAUNCHES
    out = mik.mesh_intersect(torch.tensor(o), torch.tensor(d),
                             torch.tensor(tm), mesh)
    ref = mik.mesh_intersect_plain(torch.tensor(o), torch.tensor(d),
                                   torch.tensor(tm), mesh.tri_verts)
    assert mik.LAUNCHES == before
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        mik.mesh_intersect(torch.tensor(o, device="meta"),
                           torch.tensor(d, device="meta"),
                           torch.tensor(tm, device="meta"), mesh)


def test_tri_verts_layout():
    pos, idx, *_ = _case("soup")
    mesh = ttri.MeshData.build(pos, idx)
    tv = mesh.tri_verts.numpy()
    assert tv.shape == (9, 450) and mesh.tri_verts.is_contiguous()
    for k in range(3):
        np.testing.assert_array_equal(tv[3 * k:3 * k + 3].T, pos[idx[:, k]])


def test_mesh_surface_matches_reference():
    pos, idx, uv, *_ = jmesh_gen.cornell_box(2.0)
    _, _, o, d, tm, _ = _case("cornell")
    jm = jtri.MeshData.build(pos, idx, uvs=uv)
    tm_ = ttri.MeshData.build(pos, idx, uvs=uv)
    for name in ("positions", "normals", "uvs", "tangents", "bitangents"):
        np.testing.assert_array_equal(getattr(tm_, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    t, i, b1, b2, _ = ttri.mesh_intersect_brute(
        torch.tensor(o), torch.tensor(d), torch.tensor(tm), tm_)
    a = jtri.mesh_surface(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                          jnp.asarray(i), jnp.asarray(b1), jnp.asarray(b2), jm)
    b = ttri.mesh_surface(torch.tensor(o), torch.tensor(d), t, i, b1, b2, tm_)
    for name in ("p", "n", "uv", "dpdu", "dpdv", "wo"):
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   np.asarray(getattr(a, name)), atol=1e-6)
    for name in ("valid", "backface"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(a, name)))


def test_cornell_box_mesh_identical():
    for x, y in zip(tmesh_gen.cornell_box(2.0)[:4],
                    jmesh_gen.cornell_box(2.0)[:4]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tmesh_gen.cornell_box(2.0)[4],
                    jmesh_gen.cornell_box(2.0)[4]):
        np.testing.assert_array_equal(x, y)


def test_sphere_intersect_and_surface():
    spheres = [{"radius": 0.4, "transform": jshp.make_transform((-0.35, -0.6,
                                                                 0.3))},
               {"radius": 1.0, "z_max": 0.5, "phi_max": 4.0,
                "transform": jshp.make_transform((1.0, 0.2, 0.5),
                                                 (20, 40, 10), 1.3)}]
    ja = jshp.SphereTable.build(spheres)
    tb = tshp.SphereTable.build(
        [dict(s, transform=tshp.make_transform(
            *([(-0.35, -0.6, 0.3)] if i == 0 else
              [(1.0, 0.2, 0.5), (20, 40, 10), 1.3])))
         for i, s in enumerate(spheres)])
    np.testing.assert_array_equal(tb.o2w.numpy(), np.asarray(ja.o2w))
    np.testing.assert_array_equal(tb.w2o.numpy(), np.asarray(ja.w2o))
    rng = np.random.default_rng(9)
    o = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
    d = rng.normal(0, 1, (700, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(700, np.inf, np.float32)
    ra = np.asarray(jshp.sphere_intersect_t(jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(tm), ja))
    rb = tshp.sphere_intersect_t(torch.tensor(o), torch.tensor(d),
                                 torch.tensor(tm), tb).numpy()
    np.testing.assert_array_equal(np.isfinite(ra), np.isfinite(rb))
    hit = np.isfinite(ra)
    assert hit.any(axis=0).all()
    np.testing.assert_allclose(rb[hit], ra[hit], rtol=1e-5, atol=1e-6)
    j = np.argmin(ra, axis=1)
    t = np.where(hit.any(1), ra.min(1), 1.0).astype(np.float32)
    sa = jshp.sphere_surface(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                             jnp.asarray(j), ja)
    sb = tshp.sphere_surface(torch.tensor(o), torch.tensor(d), torch.tensor(t),
                             torch.tensor(j), tb)
    for name in ("p", "n", "uv", "dpdu", "dpdv", "wo"):
        np.testing.assert_allclose(getattr(sb, name).numpy(),
                                   np.asarray(getattr(sa, name)),
                                   rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(sb.backface.numpy(), np.asarray(sa.backface))


def test_kernel_matches_plain_on_cuda():
    """Needs a CUDA card and nvcc (run by chip_smoke.py on the GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    pos, idx, o, d, tm, mask = _case("tmax_mask")
    mesh = ttri.MeshData.build(pos, idx, device="cuda")
    args = [torch.tensor(x, device="cuda") for x in (o, d, tm)]
    m = torch.tensor(mask, device="cuda")
    before = mik.LAUNCHES
    k = mik.mesh_intersect(*args, mesh, m)
    p = mik.mesh_intersect_plain(*args, mesh.tri_verts, m)
    torch.cuda.synchronize()
    assert mik.LAUNCHES == before + 1
    for x, y in zip(k, p):
        assert torch.equal(x, y)
