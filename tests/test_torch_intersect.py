"""The port's mesh intersection (plain versions of the CUDA kernel's two
modes) against the JAX reference's jnp brute force and its Pallas kernel
(interpret mode), on the soup, Cornell and mask/t_max cases of
tests/test_pallas_intersect.py with that file's tolerances; dead rays and
the per-ray counters against a numpy count; chip_smoke.py phase 4b's
helpers on CPU tensors; sphere and surface parity; and, on a CUDA machine
only, the kernel against its plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from computational_ray_tracer_tpu.ops import pallas_intersect as pk
from computational_ray_tracer_tpu.ops import shapes as jshp
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.ops import mesh_intersect_kernel as mik
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
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
    args = (torch.tensor(o), torch.tensor(d), torch.tensor(tm))
    before = (mik.LAUNCHES, mik.LAUNCHES_ANYHIT)
    out = mik.mesh_intersect(*args, mesh)
    ref = mik.mesh_intersect_plain(*args, mesh.tri_verts)
    hit = mik.mesh_anyhit(*args, mesh)
    assert (mik.LAUNCHES, mik.LAUNCHES_ANYHIT) == before
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert torch.equal(hit, mik.mesh_anyhit_plain(*args, mesh.tri_verts))
    for wrapper in (mik.mesh_intersect, mik.mesh_anyhit):
        with pytest.raises(ValueError):
            wrapper(*(x.to("meta") for x in args), mesh)


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


@pytest.mark.parametrize("name", CASES)
def test_anyhit_plain_matches_closest_hit_jnp_and_pallas(name):
    """mesh_anyhit_plain is the closest hit's id >= 0 of the port, of the
    jnp brute force (its mesh_anyhit_brute) and of the Pallas kernel in
    interpret mode, exactly."""
    jargs, jmask, got, mask = _both(name)
    pos, idx, o, d, tm, _ = _case(name)
    mesh = ttri.MeshData.build(pos, idx)
    tmask = None if mask is None else torch.tensor(mask)
    hit = mik.mesh_anyhit_plain(torch.tensor(o), torch.tensor(d),
                                torch.tensor(tm), mesh.tri_verts, tmask,
                                chunk=100).numpy()
    assert hit.dtype == np.bool_ and 0.0 < hit.mean() < 1.0
    np.testing.assert_array_equal(hit, got[1] >= 0)
    np.testing.assert_array_equal(
        hit, np.asarray(jtri.mesh_anyhit_brute(*jargs, tri_mask=jmask)))
    pallas = pk.mesh_intersect_pallas(*jargs, tri_mask=jmask, interpret=True)
    np.testing.assert_array_equal(hit, np.asarray(pallas[1]) >= 0)


@pytest.mark.parametrize("t_dead", [-1.0, 0.0])
def test_dead_rays_miss_and_test_no_pair(t_dead):
    """Rays with t_max <= 0 give (inf, -1, 0, 0), no occlusion and zero
    counters; the live rays' results do not change."""
    pos, idx, o, d, tm, _ = _case("cornell")
    mesh = ttri.MeshData.build(pos, idx)
    dead = np.arange(tm.shape[0]) % 3 != 0
    tm_dead = np.where(dead, np.float32(t_dead), tm).astype(np.float32)
    args = (torch.tensor(o), torch.tensor(d))
    full = mik.mesh_intersect_plain(*args, torch.tensor(tm), mesh.tri_verts)
    got = mik.mesh_intersect_plain(*args, torch.tensor(tm_dead),
                                   mesh.tri_verts, stats=True)
    hit, *counts = mik.mesh_anyhit_plain(
        *args, torch.tensor(tm_dead), mesh.tri_verts, stats=True)
    dead_t = torch.tensor(dead)
    assert torch.isinf(got[0][dead_t]).all()
    assert (got[1][dead_t] == -1).all()
    assert (got[2][dead_t] == 0).all() and (got[3][dead_t] == 0).all()
    assert not hit[dead_t].any()
    assert len(got) == 8 and len(counts) == 3
    for counter in (*got[5:], *counts):
        assert (counter[dead_t] == 0).all()
    for x, y in zip(got[:4], full[:4]):
        assert torch.equal(x[~dead_t], y[~dead_t])
    assert torch.equal(hit[~dead_t], full[1][~dead_t] >= 0)
    assert (got[5][~dead_t] == 12).all() and got[1][~dead_t].ge(0).any()


def _np_sign_and_range(o, d, tm, tri_verts):
    """(F, n) edge-sign test in numpy float32 (translate, permute to the
    dominant axis, shear, the three DifferenceOfProducts with the 4097
    split), then the pairs that also pass the range test (a nonzero
    determinant, 0 < t_scaled < t_max |det| in the determinant's sign)."""
    f32 = np.float32
    ad = np.abs(d)
    kz_x = (ad[:, 0] >= ad[:, 1]) & (ad[:, 0] >= ad[:, 2])
    kz_y = ~kz_x & (ad[:, 1] >= ad[:, 2])
    order = np.where(kz_x[:, None], [1, 2, 0],
                     np.where(kz_y[:, None], [2, 0, 1], [0, 1, 2]))
    dp = np.take_along_axis(d, order, 1)
    inv = f32(1.0) / dp[:, 2]
    sx, sy = -dp[:, 0] * inv, -dp[:, 1] * inv
    f = tri_verts.shape[1]
    idx = np.broadcast_to(order.T[:, None, :], (3, f, o.shape[0]))
    xy, z = [], []
    for k in range(3):
        rel = tri_verts[3 * k:3 * k + 3, :, None] - o.T[:, None, :]
        px, py, pz = np.take_along_axis(rel, idx, 0)
        xy.append((px + sx * pz, py + sy * pz))
        z.append(inv * pz)

    def err(a, b, ab):
        split = lambda v: (v * f32(4097.0)) - (v * f32(4097.0) - v)
        a_hi, b_hi = split(a), split(b)
        a_lo, b_lo = a - a_hi, b - b_hi
        return ((a_hi * b_hi - ab) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo

    def dop(a, b, c, d_):
        ab, cd = a * b, c * d_
        return (ab - cd) + (err(a, b, ab) - err(c, d_, cd))

    (ax, ay), (bx, by), (cx, cy) = xy
    e = [dop(bx, cy, by, cx), dop(cx, ay, cy, ax), dop(ax, by, ay, bx)]
    side = np.all([x >= 0 for x in e], 0) | np.all([x <= 0 for x in e], 0)
    det = (e[0] + e[1]) + e[2]
    t_scaled = (e[0] * z[0] + e[1] * z[1]) + e[2] * z[2]
    ts = np.where(det < 0, -t_scaled, t_scaled)
    in_range = (det != 0) & (ts > 0) & (ts < tm * np.abs(det))
    return side, side & in_range


@pytest.mark.parametrize("anyhit", [False, True])
def test_plain_counters_match_a_numpy_count(anyhit):
    """The plain version's per-ray counters against a loop that walks each
    live ray's kept triangles in order (any hit stops after its first hit)
    and counts the pairs tested, those past the edge-sign test and those
    past the range test as well."""
    pos, idx, o, d, tm, mask = _case("tmax_mask")
    tm = np.where(np.arange(tm.shape[0]) % 5 == 0, np.float32(-1.0), tm)
    mesh = ttri.MeshData.build(pos, idx)
    tv = mesh.tri_verts
    args = (torch.tensor(o), torch.tensor(d), torch.tensor(tm))
    fn = mik.mesh_anyhit_plain if anyhit else mik.mesh_intersect_plain
    tests, passed, ranged = fn(*args, tv, torch.tensor(mask),
                               stats=True)[-3:]
    side, in_range = _np_sign_and_range(o, d, tm, tv.numpy())
    hit = np.stack([mik.mesh_intersect_plain(*args, tv[:, j:j + 1])[1]
                    .numpy() >= 0 for j in range(tv.shape[1])])
    want_tests = np.zeros(tm.shape[0], np.int32)
    want_passed = np.zeros(tm.shape[0], np.int32)
    want_ranged = np.zeros(tm.shape[0], np.int32)
    for r in np.nonzero(tm > 0)[0]:
        for j in np.nonzero(mask)[0]:
            want_tests[r] += 1
            want_passed[r] += side[j, r]
            want_ranged[r] += in_range[j, r]
            if anyhit and hit[j, r]:
                break
    np.testing.assert_array_equal(tests.numpy(), want_tests)
    np.testing.assert_array_equal(passed.numpy(), want_passed)
    np.testing.assert_array_equal(ranged.numpy(), want_ranged)
    assert 0 < want_ranged.sum() < want_passed.sum() < want_tests.sum()
    if anyhit:
        assert (want_tests < 50).any() and (want_tests[tm > 0] <= 50).all()


def _smoke_on_host_clock(monkeypatch):
    """chip_smoke, with the host clock in place of CUDA events and the
    plain version in place of the brute-force kernel's bare launch."""
    import time
    import chip_smoke as cs

    def host_timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def plain_launch(anyhit, o, d, t_max, tri_verts, tri_mask, stats):
        fn = mik.mesh_anyhit_plain if anyhit else mik.mesh_intersect_plain
        return fn(o, d, t_max, tri_verts, tri_mask, stats=stats)
    monkeypatch.setattr(mik, "_launch", plain_launch)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "timed", host_timed)
    for name in ("median_ms", "per_launch_ms"):
        monkeypatch.setattr(cs, name, lambda fn, *a, **k: host_timed(fn)[1])
    return cs


def test_smoke_holds_each_mesh_launch_of_a_cornell_pass(monkeypatch):
    """chip_smoke.py phase 4b's helpers on CPU tensors, with the host clock
    in place of CUDA events: one Cornell pass makes its 8 brute-force
    launches as (closest, any hit) per depth, each captured launch is held
    to the plain version with its counters, and a launch's bound counts
    the work of its live rays."""
    from computational_ray_tracer_tpu_torch import entry
    cs = _smoke_on_host_clock(monkeypatch)
    scene, camera, cfg = entry.cornell_setup(16, 2, device="cpu")
    rows = cs.cornell_launches(scene, camera, cfg, {"closest": 8,
                                                    "anyhit": 8})
    assert [r["case"] for r in rows] == [
        f"cornell_{m}_d{j}" for j in range(4) for m in ("closest", "anyhit")]
    assert all(r["launches"] == 2 and r["bitwise"] and r["tests_per_live_ray"]
               <= 12 for r in rows)
    assert rows[0]["alive"] == 256 and rows[0]["tests_per_live_ray"] == 12
    assert rows[-1]["alive"] < 256
    # the bound: 108 operations a pair rejected by the sign test, 119 one
    # rejected by the range test, 151 one past both; o/d of the live rays,
    # t_max and the outputs of every ray, the mesh once
    calls = cs.capture_mesh_launches(lambda: tinteg.render_pass(
        scene, camera, cfg, tinteg.make_filter(cfg),
        tsen.PixelSensor.create(), 0))
    mode, (o, d, t), mesh, mask = calls[3]
    assert mode == "anyhit" and mask is None
    counts = mik.mesh_anyhit(o, d, t, mesh, stats=True)[1:]
    tests, passed, ranged = (int(c.sum()) for c in counts)
    assert 0 < ranged < passed < tests
    live = int((t > 0).sum())
    flops = (tests - passed) * 108 + (passed - ranged) * 119 + ranged * 151
    assert cs.brute_bound(t, counts, 12, None, 1) == cs.bound(
        flops, 24 * live + 5 * t.numel() + 36 * 12)


@pytest.mark.cuda
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


def _card_brute_case(case):
    """(mesh, o, d, t_max, mask) on the card for one card test case."""
    rng = np.random.default_rng(11)
    if case == "mostly_dead":
        pos, idx, o, d, _, _ = _case("cornell")
        tm = np.full(o.shape[0], np.inf, np.float32)
        tm[rng.uniform(size=tm.shape[0]) < 0.95] = rng.choice([0.0, -1.0])
        mask = None
    elif case == "ragged_4099":
        pos, idx, o, d = _soup(4099, 450, 2)
        tm = np.full(4099, np.inf, np.float32)
        mask = None
    else:   # masked_tiles: three tiles of triangles, half of them masked
        pos, idx, o, d = _soup(2000, 600, 3)
        tm = np.full(2000, 1.5, np.float32)
        mask = rng.uniform(size=600) < 0.5
    cuda = lambda a: torch.tensor(a, device="cuda")
    return (ttri.MeshData.build(pos, idx, device="cuda"), cuda(o), cuda(d),
            cuda(tm), None if mask is None else cuda(mask))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mostly_dead", "ragged_4099",
                                  "masked_tiles"])
def test_kernel_modes_and_counters_match_plain_on_cuda(case):
    """Both kernel modes against their plain versions, bit for bit with
    the three counters: rays mostly dead (t_max 0 or -1), a ray count that
    is not a multiple of 32 with two tiles of triangles, and three tiles
    with half the triangles masked."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    mesh, o, d, tm, mask = _card_brute_case(case)
    before = (mik.LAUNCHES, mik.LAUNCHES_ANYHIT)
    k = mik.mesh_intersect(o, d, tm, mesh, mask, stats=True)
    k_any = mik.mesh_anyhit(o, d, tm, mesh, mask, stats=True)
    p = mik.mesh_intersect_plain(o, d, tm, mesh.tri_verts, mask, stats=True)
    p_any = mik.mesh_anyhit_plain(o, d, tm, mesh.tri_verts, mask, stats=True)
    torch.cuda.synchronize()
    assert (mik.LAUNCHES, mik.LAUNCHES_ANYHIT) == (before[0] + 1,
                                                   before[1] + 1)
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    for x, y in zip(k_any, p_any):
        assert torch.equal(x, y)
    assert torch.equal(k_any[0], k[1] >= 0)
    assert k_any[0].any() and (~k_any[0]).any()
