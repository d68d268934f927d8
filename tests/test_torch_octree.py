"""The port's octree mesh path against the JAX reference on the same inputs:
the mesh generators, the tree build and pack, the plain traversal (the CUDA
kernel's plain version) against the jnp oracle and the Pallas kernel in
interpret mode, the packet order, the sRGB coefficient table, and one
direct render_pass of the mesh bench scene carried across with
convert.scene_from_numpy; and, on a CUDA machine only, the kernel against
its plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_render import export_scene
from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.models import scene as jscene_mod
from computational_ray_tracer_tpu.models.scene import Scene as JScene
from computational_ray_tracer_tpu.ops import camera as jcam
from computational_ray_tracer_tpu.ops import color as jcolor
from computational_ray_tracer_tpu.ops import octree as joct
from computational_ray_tracer_tpu.ops import pallas_octree as jpoct
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.models import scene as tscene_mod
from computational_ray_tracer_tpu_torch.ops import color as tcolor
from computational_ray_tracer_tpu_torch.ops import octree as toct
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
from computational_ray_tracer_tpu_torch.ops import triangle as ttri
from computational_ray_tracer_tpu_torch.utils import mesh_gen as tmesh_gen

T = lambda a: torch.tensor(np.asarray(a))
TREE_FIELDS = ("node_lo", "node_hi", "node_child0", "node_leaf_id",
               "leaf_tris", "leaf_counts")

GENERATORS = {
    "uv_sphere": lambda g: g.uv_sphere((0.0, 0.0, 0.0), 1.0, 24, 24),
    "displaced_icosphere_2": lambda g: g.displaced_icosphere(2),
    "displaced_icosphere_3": lambda g: g.displaced_icosphere(3),
    "checker_texture": lambda g: (g.checker_texture(32),),
    "dragon_stand_in": lambda g: g.dragon_stand_in(target_tris=6000),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_mesh_gen_matches_reference(name):
    for a, b in zip(GENERATORS[name](tmesh_gen), GENERATORS[name](jmesh_gen)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _trees(subdiv, cap):
    v, f, uv = jmesh_gen.displaced_icosphere(subdiv)
    jmesh = jtri.MeshData.build(v, f, uvs=uv)
    return (v, f, uv), joct.build_octree(jmesh, capacity=cap), jmesh, \
        toct.build_host_octree(v, f, cap)


@pytest.mark.parametrize("subdiv,cap", [(2, 40), (2, 192), (3, 40),
                                        (3, 192)])
def test_build_octree_matches_reference(subdiv, cap):
    _, jtree, _, ttree = _trees(subdiv, cap)
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(ttree, k),
                                      np.asarray(getattr(jtree, k)))
    assert ttree.info() == jtree.info()


@pytest.mark.parametrize("masked", [False, True])
def test_pack_matches_reference(masked):
    (v, f, uv), jtree, jmesh, ttree = _trees(3, 40)
    mask = (np.arange(f.shape[0]) % 3 != 0) if masked else None
    jp = jpoct.pack_from_numpy(
        joct.Octree(*[np.asarray(getattr(jtree, k)) for k in TREE_FIELDS]),
        jmesh, None if mask is None else jnp.asarray(mask))
    tp = okern.pack_from_numpy(ttree, ttri.MeshData.build(v, f, uvs=uv),
                               mask)
    for name in ("nodes", "leaf_verts", "row_tri"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert tp.cap == jp.cap and tp.depth == toct.tree_depth(ttree)


def _camera_rays(res, origin=(0, 0.4, -3.2)):
    """tests/test_pallas_octree.py's pixel-centre camera rays, as numpy."""
    camera = jcam.PerspectiveCamera.create(origin, (res, res), fov_y=40.0,
                                           look_at=(0, 0, 0))
    px = jnp.arange(res * res, dtype=jnp.uint32)
    pp = jnp.stack([(px % res).astype(jnp.float32) + 0.5,
                    (px // res).astype(jnp.float32) + 0.5], axis=-1)
    o, d = camera.generate_rays(pp, jnp.full((res * res, 2), 0.5))
    return np.asarray(o), np.asarray(d)


def _port_packed(subdiv, cap=joct.TRIANGLE_CAPACITY):
    v, f, uv = tmesh_gen.displaced_icosphere(subdiv)
    mesh = ttri.MeshData.build(v, f, uvs=uv, device="cpu")
    return okern.pack_from_numpy(toct.build_host_octree(v, f, cap), mesh)


@pytest.mark.parametrize("subdiv", [2, 3])
def test_plain_traverse_matches_jnp_oracle(subdiv):
    """Same tree, same rays, the same node order: equal hit masks, triangle
    ids and triangle-test counts. t and the barycentrics differ from the
    oracle's in the last bit on some rays: XLA compiles the oracle's
    while_loop body with fused (FMA-contracted) arithmetic, while its
    eager per-pair test, its jnp brute force and the port all round every
    operation. So t, b1, b2 are held to the Pallas gate (rtol 1e-5 /
    atol 1e-5) against the oracle, and t to bit equality against the jnp
    brute force."""
    (v, f, uv), jtree, jmesh, _ = _trees(subdiv, joct.TRIANGLE_CAPACITY)
    packed = _port_packed(subdiv)
    o, d = _camera_rays(40)
    tm = np.full(o.shape[0], np.inf, np.float32)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    ref = [np.asarray(x) for x in joct.octree_traverse(*args, jtree, jmesh)]
    got = [x.numpy() for x in okern.octree_intersect(T(o), T(d), T(tm),
                                                     packed, stats=True)]
    hit = np.isfinite(ref[0])
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5)
    for g, r in zip(got[2:4], ref[2:4]):
        np.testing.assert_allclose(g[hit], r[hit], atol=1e-5)
    assert (got[1][~hit] == -1).all() and (got[5] >= 1).all()
    brute = np.asarray(jtri.mesh_intersect_brute(*args, jmesh)[0])
    np.testing.assert_array_equal(got[0], brute)


def test_plain_traverse_matches_pallas_interpret():
    """The Pallas kernel's own gate (tests/test_pallas_octree.py:40-48)."""
    (v, f, uv), jtree, jmesh, _ = _trees(2, joct.TRIANGLE_CAPACITY)
    o, d = _camera_rays(16)
    tm = np.full(o.shape[0], np.inf, np.float32)
    ref = [np.asarray(x) for x in jpoct.octree_intersect_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
        jpoct.pack_octree(jtree, jmesh), interpret=True)]
    got = [x.numpy() for x in okern.octree_intersect(
        T(o), T(d), T(tm), _port_packed(2))]
    hit = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), hit)
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])
    for g, r in zip(got[2:4], ref[2:4]):
        np.testing.assert_allclose(g[hit], r[hit], atol=1e-5)


@pytest.mark.parametrize("t_max", [np.inf, 2.5, 0.5, -1.0])
def test_occlusion_matches_reference(t_max):
    """The any-hit wrapper against the reference's occlusion predicate (the
    jnp closest hit's id >= 0) and its Pallas any-hit kernel."""
    (v, f, uv), jtree, jmesh, _ = _trees(2, joct.TRIANGLE_CAPACITY)
    o, d = _camera_rays(24)
    tm = np.full(o.shape[0], t_max, np.float32)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    t_j, ti_j, *_ = joct.octree_traverse(*args, jtree, jmesh)
    occ_j = np.isfinite(np.asarray(t_j)) & (np.asarray(ti_j) >= 0)
    occ_p = np.asarray(jpoct.octree_anyhit_pallas(
        *args, jpoct.pack_octree(jtree, jmesh), interpret=True))
    got = okern.octree_anyhit(T(o), T(d), T(tm), _port_packed(2)).numpy()
    np.testing.assert_array_equal(got, occ_j)
    np.testing.assert_array_equal(got, occ_p)
    if t_max == np.inf:
        assert got.mean() > 0.2
    if t_max < 0:
        assert not got.any()


def test_wrappers_run_plain_on_cpu_and_count_only_kernel_launches():
    packed = _port_packed(2)
    o, d = _camera_rays(8)
    tm = np.full(o.shape[0], np.inf, np.float32)
    before = (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT)
    out = okern.octree_intersect(T(o), T(d), T(tm), packed)
    ref = toct.octree_traverse(T(o), T(d), T(tm), packed.tree,
                               packed.tri_verts)
    hit = okern.octree_anyhit(T(o), T(d), T(tm), packed)
    assert (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT) == before
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert torch.equal(hit, ref[1] >= 0)
    meta = [torch.tensor(x, device="meta") for x in (o, d, tm)]
    with pytest.raises(ValueError):
        okern.octree_intersect(*meta, packed)
    with pytest.raises(ValueError):
        okern.octree_anyhit(*meta, packed)


def test_pack_refuses_trees_deeper_than_the_kernel_stack(monkeypatch):
    v, f, uv = tmesh_gen.displaced_icosphere(3)
    tree = toct.build_host_octree(v, f, 40)
    mesh = ttri.MeshData.build(v, f, uvs=uv)
    monkeypatch.setattr(toct, "MAX_TREE_DEPTH", toct.tree_depth(tree) - 1)
    with pytest.raises(ValueError, match="MAX_TREE_DEPTH"):
        okern.pack_from_numpy(tree, mesh)


def test_octree_scene_matches_brute_scene():
    """The same mesh through the octree and through the brute test: the
    same closest hits (the per-pair arithmetic is shared)."""
    v, f, uv = tmesh_gen.displaced_icosphere(3)
    mats = [{"kind": "diffuse", "albedo_rgb": (0.5, 0.5, 0.5)}]
    lights = [{"kind": "distant", "direction": (0, -1, 0)}]

    def build(use_octree):
        return tscene_mod.Scene.build(
            mats, lights, mesh=ttri.MeshData.build(v, f, uvs=uv),
            use_octree=use_octree, device="cpu")

    o, d = _camera_rays(32)
    tm = torch.full((o.shape[0],), float("inf"))
    a = tscene_mod.scene_intersect_t(build(True), T(o), T(d), tm)[:5]
    b = tscene_mod.scene_intersect_t(build(False), T(o), T(d), tm)[:5]
    hit = torch.isfinite(b[0])
    assert hit.float().mean() > 0.2
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x[hit], y[hit])


def test_packet_order_matches_reference():
    rng = np.random.default_rng(12)
    n = 3000
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(size=n) > 0.2
    ref = np.asarray(jscene_mod._packet_order(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive)))
    got = tscene_mod._packet_order(T(o), T(d), T(alive)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert alive[got[:alive.sum()]].all()


def test_rgb_to_spectrum_table_lookup_matches():
    rng = np.random.default_rng(5)
    rgb = np.concatenate([rng.uniform(0, 1, (500, 3)),
                          rng.uniform(-0.2, 1.2, (100, 3)),
                          tmesh_gen.checker_texture(32).reshape(-1, 3)])
    rgb = rgb.astype(np.float32)
    ref = np.asarray(jcolor.RGBToSpectrumTable.srgb().lookup(
        jnp.asarray(rgb)))
    got = tcolor.RGBToSpectrumTable.srgb().lookup(T(rgb)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mesh_bench_small():
    """The mesh bench scene (bench.py's _dragon_scene) at subdiv 3, built by
    the reference, and the port's camera and config for it."""
    v, f, uv = jmesh_gen.displaced_icosphere(3)
    mesh = jtri.MeshData.build(v, f, uvs=uv)
    jsc = JScene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": (0.75, 0.71, 0.62)}],
        lights=[{"kind": "distant", "direction": (-0.4, -1.0, 0.5),
                 "rgb": (1.0, 1.0, 1.0), "scale": 4.0},
                {"kind": "ambient", "spd_named": "stdillum-D65",
                 "scale": 0.15}],
        mesh=(mesh, jnp.zeros((mesh.n_triangles,), jnp.int32)),
        use_octree=True, octree_capacity=192)
    jcamera = jcam.PerspectiveCamera.create((0, 0.5, -3.4), (32, 32),
                                            fov_y=40.0, look_at=(0, 0, 0))
    jcfg = jinteg.RenderConfig(
        resolution=(32, 32), sampler=jinteg.SamplerConfig(kind="sobol",
                                                          spp=2),
        integrator="direct", max_depth=1)
    tsc, tcamera, tcfg = entry.mesh327k_setup(res=32, spp=2, subdiv=3,
                                              device="cpu")
    return jsc, jcamera, jcfg, tsc, tcamera, tcfg


@pytest.mark.parametrize("sample_idx", [0, 1])
def test_direct_render_pass_matches_jax(mesh_bench_small, sample_idx):
    """One direct render_pass of the mesh bench scene carried across (same
    tree, same parameters) against the JAX render_pass, at the tolerance of
    test_render_pass_matches_jax."""
    jsc, jcamera, jcfg, tsc, tcamera, tcfg = mesh_bench_small
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tsc.octree, k),
                                      np.asarray(getattr(jsc.octree, k)))
    carried = convert.scene_from_numpy(export_scene(jsc), device="cpu")
    f, s = jinteg.make_filter(jcfg), jinteg.make_sensor(jcfg)
    rj, wj = jax.jit(lambda sc, i: jinteg.render_pass(
        sc, jcamera, jcfg, f, s, i))(jsc, jnp.uint32(sample_idx))
    rt, wt = tinteg.render_pass(carried, tcamera, tcfg, tinteg.make_filter(tcfg),
                                tsen.PixelSensor.create(), sample_idx)
    rj, wj = np.asarray(rj), np.asarray(wj)
    assert np.isfinite(rt.numpy()).all() and rj.max() > 0.05
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                               atol=2e-3 * max(float(rj.max()), 1e-3))
    # The port's own build renders the same image as the carried scene.
    own, _ = tinteg.render_pass(tsc, tcamera, tcfg, tinteg.make_filter(tcfg),
                                tsen.PixelSensor.create(), sample_idx)
    np.testing.assert_allclose(own.numpy(), rt.numpy(), rtol=0,
                               atol=2e-3 * max(float(rj.max()), 1e-3))


def test_stack_entry_check_refuses_group_ids_beyond_24_bits():
    """The wrapper's check that every sibling-group id fits the kernel's
    compressed stack entry (24 bits of id, 8 bits of child mask)."""
    assert okern.STACK_GROUP_BITS == 24
    okern.check_stack_entry_fits(1)
    okern.check_stack_entry_fits(1 << 24)
    okern.check_stack_entry_fits(_port_packed(3, 40).nodes.shape[0])
    for bad in ((1 << 24) + 1, 1 << 30):
        with pytest.raises(ValueError, match="stack entry"):
            okern.check_stack_entry_fits(bad)


def _smoke_on_host_clock(monkeypatch):
    """chip_smoke, with the host clock in place of CUDA events."""
    import time
    import chip_smoke as cs

    def host_timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "timed", host_timed)
    for name in ("median_ms", "per_launch_ms"):
        monkeypatch.setattr(cs, name, lambda fn, *a, **k: host_timed(fn)[1])
    return cs


def test_smoke_holds_each_octree_launch_of_a_flagship_pass(monkeypatch):
    """chip_smoke.py phase 10b's helpers on CPU tensors, with the host clock
    in place of CUDA events: one flagship pass makes its 8 octree launches
    as (closest, any hit) per depth, each captured launch is held to the
    plain traversal, and the plain check takes all rays or, where all would
    exceed the budget, the seeded subset."""
    cs = _smoke_on_host_clock(monkeypatch)
    m_scene, _, _ = entry.mesh327k_setup(16, 2, subdiv=2, device="cpu")
    f_scene, f_camera, f_cfg = entry.flagship_setup(16, 4, scene=m_scene,
                                                    device="cpu")
    rows = cs.flagship_bounces(f_scene, f_camera, f_cfg,
                               {"closest": 8, "anyhit": 8})
    assert [r["case"] for r in rows] == [
        f"flagship_{m}_d{j}" for j in range(4) for m in ("closest", "anyhit")]
    assert all(r["launches"] == 2 and r["plain_rays"] == "all"
               and r["max_abs_err"] == 0.0 for r in rows)
    assert rows[0]["alive"] == 256 and rows[0]["tri_tests_mean"] > 0
    monkeypatch.setattr(cs, "PLAIN_SUBSET", 50)
    monkeypatch.setattr(cs, "PLAIN_BUDGET_S", 0.0)
    o, d = _camera_rays(16)
    t = torch.full((256,), float("inf"))
    label, (so, sd, st), _ = cs.plain_ray_set(f_scene.packed_octree, T(o),
                                              T(d), t)
    assert label == "seeded subset of 50" and so.shape == (50, 3)
    assert st.shape == (50,) and sd.shape == (50, 3)


def test_smoke_octree_bound_counts_what_a_launch_touches():
    """chip_smoke's octree bound: each counted triangle test the
    edge-sign test's operations, each pop its slab tests; t_max and the
    outputs count for every ray, o and d for the live rays only; the tree
    tables count whole where the counted pops and tests would read more,
    else one group row per pop and one triangle slot per test (a sparse
    bounce wavefront)."""
    import chip_smoke as cs
    from computational_ray_tracer_tpu_torch.ops import (
        mesh_intersect_kernel as mik)
    packed = _port_packed(3, 40)
    o, d = (T(x) for x in _camera_rays(32))
    n = o.shape[0]
    t_full = torch.full((n,), float("inf"))
    full = okern.octree_intersect(o, d, t_full, packed, stats=True)[4:]
    # One live ray with 40 triangle tests and 12 pops.
    one = torch.arange(n) == 16 * 32 + 16
    t_one = torch.where(one, t_full, 0.0)
    sparse = (40 * one.to(torch.int32), 12 * one.to(torch.int32))
    for t, (tests, pops), out_words, whole in (
            (t_full, full, 4, True), (t_one, sparse, 1, False)):
        touched = (4 * 8 * okern.NODE_LANES * int(pops.sum())
                   + 4 * okern.TRI_LANES * int(tests.sum()))
        assert (touched > packed.nbytes()) == whole
        flops = (int(tests.sum()) * mik.EDGE_FLOPS
                 + int(pops.sum()) * 8 * okern.SLAB_FLOPS)
        nbytes = (4 * n * (1 + out_words) + 24 * int((t > 0).sum())
                  + min(touched, packed.nbytes()))
        assert cs.octree_bound(packed, t, tests, pops, out_words) == \
            cs.bound(flops, nbytes)


@pytest.mark.parametrize("fault", ["live_hit_lost", "dead_ray_hit"])
def test_smoke_closest_check_is_not_diluted_by_dead_rays(monkeypatch, fault):
    """chip_smoke's closest-hit check of a captured launch on a sparse
    wavefront (64 live rays of 16,384): a kernel that loses one live ray's
    hit fails it although the hit masks still agree on 99.99% of all rays,
    and so does one that reports a hit on a dead ray."""
    cs = _smoke_on_host_clock(monkeypatch)
    packed = _port_packed(3, 40)
    o, d = (T(x) for x in _camera_rays(128))
    n = o.shape[0]
    t = torch.zeros(n)
    t[64 * 128 + torch.arange(32, 96)] = float("inf")
    real = okern.octree_intersect

    def faulty(o, d, t_max, packed, stats=False):
        out = [x.clone() for x in real(o, d, t_max, packed, stats=stats)]
        if fault == "live_hit_lost":
            j = int(torch.nonzero(torch.isfinite(out[0]))[0])
            out[0][j], out[1][j] = float("inf"), -1
        else:
            j = int(torch.nonzero(t_max <= 0)[0])
            out[0][j], out[1][j] = 1.0, 0
        return tuple(out)

    row = cs.octree_launch_row("sparse", packed, "closest", (o, d, t))
    assert row["bitwise"] and row["live_rays_checked"] == 64
    assert row["rays"] == n and row["alive"] == 64
    monkeypatch.setattr(okern, "octree_intersect", faulty)
    match = "hit masks agree" if fault == "live_hit_lost" else "dead ray"
    with pytest.raises(AssertionError, match=match):
        cs.octree_launch_row("sparse", packed, "closest", (o, d, t))


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """Needs a CUDA card and nvcc (chip_smoke.py runs the full-size checks
    on the GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    v, f, uv = tmesh_gen.displaced_icosphere(3)
    mesh = ttri.MeshData.build(v, f, uvs=uv, device="cuda")
    packed = okern.pack_from_numpy(toct.build_host_octree(v, f, 40), mesh)
    o, d = (torch.tensor(x, device="cuda") for x in _camera_rays(40))
    for t_max in (float("inf"), 2.5, -1.0):
        tm = torch.full((o.shape[0],), t_max, device="cuda")
        before = (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT)
        k = okern.octree_intersect(o, d, tm, packed)
        k_any = okern.octree_anyhit(o, d, tm, packed)
        p = toct.octree_traverse(o, d, tm, packed.tree, packed.tri_verts)
        torch.cuda.synchronize()
        assert (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(k_any, p[1] >= 0)
        assert torch.equal(torch.isfinite(k[0]), torch.isfinite(p[0]))
        hit = torch.isfinite(p[0])
        torch.testing.assert_close(k[0][hit], p[0][hit], rtol=1e-5, atol=0)
        if t_max < 0:
            assert not hit.any() and not k_any.any()
        else:
            assert (k[1][hit] == p[1][hit]).float().mean() > 0.999


def _card_case(case):
    """(packed tree, o, d, t_max) on the card for one card test case."""
    rng = np.random.default_rng(21)
    if case == "canonical_depth":
        scene = entry.canonical_scene(40, device="cuda")
        camera, cfg = entry.canonical_view(64, 1)
        _, _, _, o, d = tinteg.camera_wavefront(
            camera, cfg, tinteg.make_filter(cfg), 0, "cuda")
        o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
        assert scene.packed_octree.depth == 11
        return scene.packed_octree, o, d, torch.full(
            (o.shape[0],), float("inf"), device="cuda")
    v, f, uv = tmesh_gen.displaced_icosphere(3)
    mesh = ttri.MeshData.build(v, f, uvs=uv, device="cuda")
    packed = okern.pack_from_numpy(toct.build_host_octree(v, f, 40), mesh)
    if case == "incoherent":
        n = 8192
        o = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tm = np.full(n, np.inf, np.float32)
    else:
        o, d = _camera_rays(72)
        n = 4099 if case == "ragged" else o.shape[0]
        o, d = o[:n], d[:n]
        tm = np.full(n, np.inf, np.float32)
        if case == "mostly_dead":
            tm[rng.uniform(size=n) < 0.95] = rng.choice([0.0, -1.0])
    cuda = lambda a: torch.tensor(a, device="cuda")
    return packed, cuda(o), cuda(d), cuda(tm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mostly_dead", "incoherent", "ragged",
                                  "canonical_depth"])
def test_kernel_matches_plain_on_cuda_cases(case):
    """The redesigned kernel (persistent warps, compressed shared-memory
    stack, while-while leaves) against the plain traversal, both modes:
    rays mostly dead (t_max <= 0), seeded incoherent directions, a ray
    count that is not a multiple of 32, and the canonical tree (depth 11,
    culled). Closest hits to the Pallas gate (rtol 1e-5 on t, atol 1e-5 on
    b1/b2 where the ids agree), ids equal but at ties; any hit exactly."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    packed, o, d, tm = _card_case(case)
    before = (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT)
    k = okern.octree_intersect(o, d, tm, packed, stats=True)
    k_any, tests_any, _ = okern.octree_anyhit(o, d, tm, packed, stats=True)
    p = toct.octree_traverse(o, d, tm, packed.tree, packed.tri_verts,
                             packed.tri_mask)
    torch.cuda.synchronize()
    assert (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(k_any, p[1] >= 0)
    hit = torch.isfinite(p[0])
    assert torch.equal(torch.isfinite(k[0]), hit)
    assert torch.equal(k[1][~hit], p[1][~hit])
    torch.testing.assert_close(k[0][hit], p[0][hit], rtol=1e-5, atol=0)
    same = hit & (k[1] == p[1])
    assert same.sum() >= 0.999 * hit.sum()
    for a, b in zip(k[2:4], p[2:4]):
        torch.testing.assert_close(a[same], b[same], rtol=0, atol=1e-5)
    dead = tm <= 0
    for counter in (k[4], k[5], tests_any):
        assert (counter[dead] == 0).all()
    assert (k[5][~dead] >= 1).all()
    if case != "mostly_dead":
        assert hit.float().mean() > 0.02


# --- the octree build's disk cache and the reference's build form -----------

@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """asset_cache writing under the test's tmp dir, the cache on, and the
    builder calls counted."""
    from computational_ray_tracer_tpu_torch.utils import asset_cache
    monkeypatch.setattr(asset_cache, "_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("CRT_OCTREE_CACHE", raising=False)
    calls = []
    native = toct._BUILDERS["native"]

    def counted(*args):
        calls.append(args[2:])
        return native(*args)

    monkeypatch.setitem(toct._BUILDERS, "native", counted)
    return tmp_path, calls


def _equal_trees(a, b):
    for k in TREE_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_octree_cache_hit_skips_the_build(cache_dir, monkeypatch):
    """The second build of a mesh reads the cache (the builder is not
    called) and gives the rebuilt tree bit for bit; another capacity
    misses; CRT_OCTREE_CACHE=0 builds and stores nothing."""
    tmp, calls = cache_dir
    trees = lambda: list(tmp.glob("torch_octree_*.npz"))
    v, f, _ = tmesh_gen.displaced_icosphere(3)
    first = toct.build_host_octree(v, f, 40)
    assert len(calls) == 1 and len(trees()) == 1
    second = toct.build_host_octree(v, f, 40)
    assert len(calls) == 1
    _equal_trees(second, first)
    toct.build_host_octree(v, f, 41)
    assert calls[-1][0] == 41 and len(calls) == 2
    monkeypatch.setenv("CRT_OCTREE_CACHE", "0")
    for p in trees():
        p.unlink()
    rebuilt = toct.build_host_octree(v, f, 40)
    assert len(calls) == 3 and not trees()
    _equal_trees(second, rebuilt)
    _equal_trees(toct.build_host_octree(v, f, 40, backend="numpy"), rebuilt)


def test_build_octree_reference_form(cache_dir):
    """build_octree(mesh, capacity, pack=True, tri_mask=...) gives the
    tree as tensors equal to the reference's, and the host form's packed
    tables; octree_traverse takes the MeshData and gives five values (six
    with pops)."""
    _, calls = cache_dir
    v, f, uv = jmesh_gen.displaced_icosphere(3)
    mask = np.arange(f.shape[0]) % 3 != 0
    mesh = ttri.MeshData.build(v, f, uvs=uv)
    tree, packed = toct.build_octree(mesh, 40, pack=True,
                                     tri_mask=torch.as_tensor(mask))
    host = toct.build_host_octree(v, f, 40)
    assert len(calls) == 1
    jtree = joct.build_octree(jtri.MeshData.build(v, f, uvs=uv), 40)
    for k in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tree, k).numpy(),
                                      np.asarray(getattr(jtree, k)))
        assert getattr(tree, k).device == mesh.positions.device
    want = okern.pack_from_numpy(host, mesh, mask)
    for name in ("nodes", "leaf_verts", "row_tri"):
        assert torch.equal(getattr(packed, name), getattr(want, name))
    assert not isinstance(toct.build_octree(mesh, 40), tuple)
    pos, idx = toct.host_mesh_arrays(mesh)
    assert pos.dtype == np.float32 and idx.dtype == np.int32
    o, d = _camera_rays(8)
    tm = torch.full((o.shape[0],), float("inf"))
    five = toct.octree_traverse(T(o), T(d), tm, tree, mesh)
    six = toct.octree_traverse(T(o), T(d), tm, tree, mesh.tri_verts,
                               pops=True)
    assert len(five) == 5 and len(six) == 6 and six[5].sum() > 0
    for x, y in zip(five, six):
        assert torch.equal(x, y)
