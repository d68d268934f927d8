"""The port's ray/triangle tests, ODE solvers, crossbridge simulation and
2D geometry against the JAX reference on the same numpy-seeded inputs.

Tolerances: hit masks, predicates, triangulations, ears, crossbridge
counts and guard coverage exactly; ``triangle_intersect`` bitwise in t
and, on hits, in the barycentrics (the arithmetic of
``test_plain_matches_jnp_brute``); element-wise float32 results and ODE
trajectories rtol 1e-5 / atol 1e-6 (the crossbridge forces are sums over
the bridges in another order); visibility-polygon vertices 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computational_ray_tracer_tpu.geometry2d import polygon as jpg
from computational_ray_tracer_tpu.geometry2d import segment as jseg
from computational_ray_tracer_tpu.geometry2d import visibility as jvis
from computational_ray_tracer_tpu.models import simulation as jsim
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu_torch.geometry2d import polygon as tpg
from computational_ray_tracer_tpu_torch.geometry2d import segment as tseg
from computational_ray_tracer_tpu_torch.geometry2d import visibility as tvis
from computational_ray_tracer_tpu_torch.models import simulation as tsim
from computational_ray_tracer_tpu_torch.ops import triangle as ttri

RNG = np.random.default_rng(5)
J = jnp.asarray
T = lambda a: torch.tensor(np.asarray(a))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch: the tier-1 run puts six workers on
    the cores, and each worker's full thread pool would oversubscribe them
    (the crossbridge's thousands of small steps ran 50x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def bitwise(got, want):
    equal(np.asarray(got).view(np.uint32), np.asarray(want).view(np.uint32))


# ---------------------------------------------------------------------------
# triangle
# ---------------------------------------------------------------------------

def _rays_and_triangles(n=3000):
    p = [RNG.normal(0, 1, (n, 3)).astype(np.float32) for _ in range(3)]
    o = RNG.normal(0, 3, (n, 3)).astype(np.float32)
    # aim most rays at a point inside their triangle, the rest anywhere
    bary = RNG.dirichlet((1, 1, 1), n).astype(np.float32)
    target = bary[:, :1] * p[0] + bary[:, 1:2] * p[1] + bary[:, 2:] * p[2]
    d = np.where(RNG.uniform(0, 1, (n, 1)) < 0.7, target - o,
                 RNG.normal(0, 1, (n, 3))).astype(np.float32)
    d[::50] = [0.0, 0.0, 1.0]
    t_max = np.where(RNG.uniform(0, 1, n) < 0.1, 0.5, 1e30).astype(
        np.float32)
    return o, d, t_max, p


def test_triangle_intersect_bitwise():
    o, d, t_max, p = _rays_and_triangles()
    got = ttri.triangle_intersect(T(o), T(d), T(t_max), *map(T, p))
    want = jtri.triangle_intersect(J(o), J(d), J(t_max), *map(J, p))
    hit = np.asarray(want[4])
    assert 0.3 * len(hit) < hit.sum() < len(hit)
    equal(got[4], hit)
    bitwise(got[0], want[0])
    for k in (1, 2, 3):
        bitwise(np.asarray(got[k])[hit], np.asarray(want[k])[hit])
    # broadcast pairs: rays (n, 1, 3) against triangles (1, F, 3)
    sl = lambda a: a[:40]
    got = ttri.triangle_intersect(T(sl(o))[:, None], T(sl(d))[:, None],
                                  T(sl(t_max))[:, None],
                                  *[T(sl(x))[None] for x in p])
    want = jtri.triangle_intersect(J(sl(o))[:, None], J(sl(d))[:, None],
                                   J(sl(t_max))[:, None],
                                   *[J(sl(x))[None] for x in p])
    equal(got[4], want[4])
    bitwise(got[0], want[0])


def test_mesh_vertices_and_bounds():
    pos = RNG.normal(0, 1, (30, 3)).astype(np.float32)
    idx = RNG.integers(0, 30, (20, 3)).astype(np.int32)
    a = jtri.MeshData.build(pos, idx)
    b = ttri.MeshData.build(pos, idx)
    ids = RNG.integers(0, 20, (4, 5))
    for got, want in zip(b.triangle_vertices(T(ids)),
                         a.triangle_vertices(J(ids))):
        equal(got, want)
    for got, want in zip(b.bounds(), a.bounds()):
        equal(got, want)


def test_simple_triangle_intersect():
    o, d, t_max, p = _rays_and_triangles()
    got = ttri.simple_triangle_intersect(T(o), T(d), T(t_max), *map(T, p))
    want = jtri.simple_triangle_intersect(J(o), J(d), J(t_max), *map(J, p))
    hit = np.asarray(want[4])
    equal(got[4], hit)
    for k in range(4):
        close(np.asarray(got[k])[hit], np.asarray(want[k])[hit])


# ---------------------------------------------------------------------------
# simulation
# ---------------------------------------------------------------------------

A = np.array([[-1.0, 0.5], [-0.3, -0.8]], np.float32)


@pytest.mark.parametrize("name", ["euler", "rk2", "rk4"])
def test_ode_solvers(name):
    tf = lambda t, y: T(A) @ y + torch.sin(t)
    jf = lambda t, y: J(A) @ y + jnp.sin(t)
    y0 = np.array([1.0, -0.5], np.float32)
    ts, ys = tsim.SOLVERS[name](tf, y0, 0.25, 0.05, 120,
                                 device="cpu")
    jts, jys = jsim.SOLVERS[name](jf, J(y0), 0.25, 0.05, 120)
    assert ys.shape == (120, 2)
    close(ts, jts)
    close(ys, jys)


def test_crossbridges_match_reference():
    kw = dict(n_bridges=1500, seed=3, attach_rate=30.0, detach_rate=90.0)
    tcfg, jcfg = tsim.CrossbridgeConfig(**kw), jsim.CrossbridgeConfig(**kw)
    for v in (0.0, 2.5):
        got = tsim.simulate_crossbridges(tcfg, 600, v, device="cpu")
        want = jsim.simulate_crossbridges(jcfg, 600, v)
        equal(got["n_attached"], want["n_attached"])
        equal(got["final_attached"], want["final_attached"])
        close(got["force"], want["force"])
        close(got["final_x"], want["final_x"])
    assert tsim.steady_state_attachment_fraction(tcfg) == \
        jsim.steady_state_attachment_fraction(jcfg)
    vels = np.linspace(0.0, 8.0, 5)
    close(tsim.force_velocity_curve(tcfg, vels, 300, 100, device="cpu"),
          jsim.force_velocity_curve(jcfg, J(vels), 300, 100))


# ---------------------------------------------------------------------------
# geometry2d
# ---------------------------------------------------------------------------

def _pts(n, scale=2.0):
    return RNG.uniform(-scale, scale, (n, 2)).astype(np.float32)


def test_segment_predicates():
    a, b, c, d = (_pts(3000) for _ in range(4))
    # a third of c on segment ab, a tenth of d collinear with ab
    t = RNG.uniform(0, 1, (3000, 1)).astype(np.float32)
    c[::3] = (a + t * (b - a))[::3]
    d[::10] = (a + 2.0 * (b - a))[::10]
    close(tseg.orientation(T(a), T(b), T(c)), jseg.orientation(J(a), J(b),
                                                               J(c)))
    for name, args in (("is_left_turn", (a, b, c)),
                       ("is_right_turn", (a, b, c)),
                       ("collinear", (a, b, d)),
                       ("on_segment", (c, a, b)),
                       ("segments_intersect", (a, b, c, d))):
        equal(getattr(tseg, name)(*map(T, args)),
              getattr(jseg, name)(*map(J, args)))
    equal(tseg.segments_intersect(T(a), T(b), T(c), T(d), False),
          jseg.segments_intersect(J(a), J(b), J(c), J(d), False))
    pt, par = tseg.line_line_intersection(T(a), T(b), T(c), T(d))
    jpt, jpar = jseg.line_line_intersection(J(a), J(b), J(c), J(d))
    equal(par, jpar)
    ok = ~np.asarray(jpar) & (np.abs(np.asarray(jpt)).max(-1) < 1e3)
    close(pt.numpy()[ok], np.asarray(jpt)[ok])
    got = tseg.segment_segment_intersection_point(T(a), T(b), T(c), T(d))
    want = jseg.segment_segment_intersection_point(J(a), J(b), J(c), J(d))
    valid = np.asarray(want[3])
    equal(got[3], valid)
    for k in range(3):
        close(np.asarray(got[k])[valid], np.asarray(want[k])[valid])
    close(tseg.point_segment_distance(T(c), T(a), T(b)),
          jseg.point_segment_distance(J(c), J(a), J(b)))
    e = _pts(3000, 0.5)
    close(tseg.point_triangle_distance(T(e), T(a), T(b), T(c)),
          jseg.point_triangle_distance(J(e), J(a), J(b), J(c)))


@pytest.mark.parametrize("n, seed", [(9, 0), (12, 4)])
def test_polygon_host_logic(n, seed, tmp_path):
    a = jpg.Polygon.random_simple(n, rng=np.random.default_rng(seed))
    b = tpg.Polygon.random_simple(n, rng=np.random.default_rng(seed))
    equal(b.v, a.v)
    for p in (a, b):
        p.v = p.v[::-1].copy()          # start clockwise
    assert b.ears() == a.ears() and b.mouths() == a.mouths()
    equal(b.triangulate(), a.triangulate())
    a.make_ccw()
    b.make_ccw()
    equal(b.v, a.v)
    assert b.ears() == a.ears() and b.mouths() == a.mouths()
    equal(b.triangulate(), a.triangulate())
    close(b.internal_angles(), a.internal_angles(), rtol=0, atol=1e-12)
    for i, j in np.random.default_rng(seed).integers(0, n, (12, 2)):
        assert b.is_diagonal(i, j) == a.is_diagonal(i, j)
    q = np.random.default_rng(seed + 1).uniform(-1.5, 1.5, (40, 2))
    assert [b.contains(p) for p in q] == [a.contains(p) for p in q]
    for p in q[:10]:
        assert b.hit_vertex(p, 0.3) == a.hit_vertex(p, 0.3)
        assert b.hit_edge(p, 0.2) == a.hit_edge(p, 0.2)
    for op, args in (("add_vertex", ((0.1, 0.2), 3)),
                     ("add_vertex", ((1, 1),)), ("remove_vertex", (-1,)),
                     ("split_edge", (2,)), ("shift", ((0.5, -0.25),)),
                     ("shift_vertex", (4, (0.1, 0))),
                     ("rotate", (0.3,)), ("scale", (1.5, (0.2, 0.1)))):
        getattr(a, op)(*args)
        getattr(b, op)(*args)
        equal(b.v, a.v)
    path = os.path.join(tmp_path, "p.txt")
    b.save_txt(path)
    equal(tpg.Polygon.load_txt(path).v, jpg.Polygon.load_txt(path).v)


def test_points_in_polygon_and_visibility():
    poly_j = jpg.Polygon.random_simple(18, rng=np.random.default_rng(7))
    poly_t = tpg.Polygon.random_simple(18, rng=np.random.default_rng(7))
    pts = _pts(4000, 1.6)
    v32 = poly_t.v.astype(np.float32)
    equal(tpg.points_in_polygon(T(pts), T(v32)),
          jpg.points_in_polygon(J(pts), J(v32)))
    dirs = RNG.normal(0, 1, (300, 2)).astype(np.float32)
    g = np.array([0.05, -0.02], np.float32)
    tp, tt = tvis.first_boundary_hit(T(g), T(dirs), T(v32))
    jp, jt = jvis.first_boundary_hit(J(g), J(dirs), J(v32))
    equal(np.isfinite(tt.numpy()), np.isfinite(np.asarray(jt)))
    close(tt, jt)
    close(tp, jp)
    guards = [poly_t.centroid(), poly_t.v[3] * 0.9 + poly_t.centroid() * 0.1]
    for gpt in guards:
        a = jvis.visibility_polygon(poly_j, gpt)
        b = tvis.visibility_polygon(poly_t, gpt, device="cpu")
        assert len(b) == len(a)
        close(b.v, a.v, rtol=1e-5, atol=1e-5)
    for p, q in ((guards[0], guards[1]), (guards[0], poly_t.v[7] * 0.95),
                 (poly_t.v[1] * 0.9, poly_t.v[9] * 0.9)):
        assert tvis.is_visible(poly_t, p, q) == jvis.is_visible(poly_j, p, q)
    assert tvis.guard_coverage(poly_t, guards[:1],
                               rng=np.random.default_rng(2),
                               device="cpu") == \
        jvis.guard_coverage(poly_j, guards[:1], rng=np.random.default_rng(2))
    assert tvis.guard_coverage(poly_t, guards, device="cpu") == \
        jvis.guard_coverage(poly_j, guards)
