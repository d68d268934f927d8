"""The sample index on the device: the port's passes on a 0-d int64 index
tensor against the same passes on a Python int, and its cycle walk against
the JAX reference, on the CPU.

``render()`` and ``entry.canonical_render()`` replay one captured CUDA
graph for every pass after the first (``integrator.pass_graph``): the
captured pass reads its index from a device tensor that each replay steps
in place, and reads nothing back to the host. Here: the masked cycle walk
of ``rng.permutation_element`` bit for bit against the reference's
``while_loop`` for every i < n; each sampler kind's pass on a tensor index
bit for bit the pass on the int index, and against the JAX ``render_pass``
at the golden tolerance; ``canonical_pass`` likewise; a loop over an index
bumped in place equal to ``render_passes`` over ints; every tensor-index
pass free of host reads and host-built tensors (a dispatch mode records
them), the condition of the capture. The capture itself runs on the card
only (the ``cuda``-marked test, and ``chip_smoke.py`` phase 23)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from __graft_entry__ import _cornell_setup
from test_torch_render import export_scene
from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.ops import rng as jrng
from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.ops import octree as octmod
from computational_ray_tracer_tpu_torch.ops import rng as trng
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
from computational_ray_tracer_tpu_torch.utils import mesh_gen as tmesh_gen

KEYS = np.random.default_rng(14).integers(
    0, 2 ** 32, size=2000, dtype=np.uint64).astype(np.uint32)

# Each sampler kind at 16x16; stratified 3 x 2 and Sobol spp 6 walk their
# permutations (6 is not a power of two).
SAMPLERS = {
    "independent": dict(kind="independent", spp=4),
    "stratified": dict(kind="stratified", spp=6, xs=3, ys=2),
    "sobol": dict(kind="sobol", spp=6),
    "sobol_global": dict(kind="sobol_global", spp=4),
}


def _t(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


@pytest.mark.parametrize("n", [3, 5, 100, 1000])
def test_masked_walk_matches_jax(n):
    """(w + 1) - n masked steps equal the reference's while_loop bit for
    bit for every i < n and 2,000 seeded keys; for i >= n (where the
    reference's loop may not end) the result lies in [0, n)."""
    keys = KEYS[:2000 if n < 1000 else 500]
    i = np.repeat(np.arange(n, dtype=np.uint32), keys.size)
    p = np.tile(keys, n)
    ref = np.asarray(jax.jit(lambda i_, p_: jrng.permutation_element(
        i_, n, p_))(i, p))
    got = trng.permutation_element(_t(i), n, _t(p))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    # a device index: one 0-d tensor against every key
    for s in (0, n - 1):
        np.testing.assert_array_equal(
            trng.permutation_element(torch.tensor(s), n, _t(keys)).numpy(),
            got.numpy().reshape(n, -1)[s])
    beyond = trng.permutation_element(torch.arange(n, 4 * n + 7), n,
                                      _t(keys[:1]))
    assert int(beyond.min()) >= 0 and int(beyond.max()) < n


def test_walk_of_a_python_int():
    """Python ints walk on the host to the same values as tensors."""
    for n in (3, 100):
        for s in (0, 1, n - 1):
            got = trng.permutation_element(s, n, int(KEYS[7]))
            assert got == int(trng.permutation_element(torch.tensor(s), n,
                                                       int(KEYS[7])))


def _cornell(kind, res=16):
    scene, camera, cfg = entry.cornell_setup(res=res, spp=4, device="cpu")
    return scene, camera, dataclasses.replace(
        cfg, sampler=tinteg.SamplerConfig(**SAMPLERS[kind]))


class _HostReads(TorchDispatchMode):
    """Records each op of a block that reads a tensor's value to the host
    (``.item()``, ``bool()``, ``int()``), sizes its output from the data
    (nonzero, boolean indexing) or lifts host data into a tensor
    (``torch.tensor``, ``torch.as_tensor``): on the card each is a host
    sync or a pageable copy, and a CUDA graph capture fails on it. The
    plain octree traversal, which stands in for the kernel on the CPU, is
    left out (``paused``)."""

    NAMES = ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
             "unique", "_unique2", "repeat_interleave")

    def __init__(self):
        super().__init__()
        self.seen = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        indices = args[1] if name.startswith("index") and len(args) > 1 \
            else ()
        if not self.paused and (name in self.NAMES or any(
                isinstance(x, torch.Tensor) and x.dtype == torch.bool
                for x in (indices or ()))):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _host_reads(fn, *args, monkeypatch=None):
    """(fn(*args), the host reads it made) with the plain octree traversal
    left out."""
    mode = _HostReads()
    if monkeypatch is not None:
        plain = octmod.octree_traverse

        def traverse(*a, **kw):
            mode.paused = True
            try:
                return plain(*a, **kw)
            finally:
                mode.paused = False
        monkeypatch.setattr(octmod, "octree_traverse", traverse)
    with mode:
        out = fn(*args)
    return out, mode.seen


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_tensor_index_pass_equals_int_pass(kind):
    """render_pass on a 0-d int64 index equals the pass on the int index
    bit for bit, and (after one pass has built the per-device constants)
    reads nothing back to the host and lifts no host data."""
    scene, camera, cfg = _cornell(kind)
    flt, sensor = tinteg.make_filter(cfg), tsen.PixelSensor.create()
    for s in (0, 3):
        want = tinteg.render_pass(scene, camera, cfg, flt, sensor, s)
        got, reads = _host_reads(tinteg.render_pass, scene, camera, cfg, flt,
                                 sensor, torch.tensor(s))
        assert reads == [], reads
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tensor_index_pass_matches_jax():
    """The tensor-index pass against the JAX render_pass (through the
    brute-force kernel's plain jnp reference) at the golden tolerance."""
    jscene, jcamera, jcfg = _cornell_setup(res=16, spp=2, use_pallas=False)
    tscene = convert.scene_from_numpy(export_scene(jscene), device="cpu")
    _, tcamera, tcfg = entry.cornell_setup(res=16, spp=2, device="cpu")
    f, s = jinteg.make_filter(jcfg), jinteg.make_sensor(jcfg)
    rj, wj = (np.asarray(x) for x in jax.jit(lambda sc, i: jinteg.render_pass(
        sc, jcamera, jcfg, f, s, i))(jscene, jnp.uint32(1)))
    rt, wt = tinteg.render_pass(tscene, tcamera, tcfg,
                                tinteg.make_filter(tcfg),
                                tsen.PixelSensor.create(), torch.tensor(1))
    assert np.isfinite(rt.numpy()).all() and float(rj.max()) > 0.05
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                               atol=2e-3 * max(float(rj.max()), 1e-3))


def test_flagship_pass_tensor_index(monkeypatch):
    """The flagship at 16x16 over the subdiv-3 mesh (octree closest and
    any hit, texture, thin lens, stratified 2x2, path/MIS depth 4): the
    tensor-index pass equals the int pass bit for bit and reads nothing
    back to the host."""
    scene, camera, cfg = entry.flagship_setup(
        16, scene=entry.mesh327k_setup(16, subdiv=3, cap=32, device="cpu")[0],
        device="cpu")
    flt, sensor = tinteg.make_filter(cfg), tsen.PixelSensor.create()
    want = tinteg.render_pass(scene, camera, cfg, flt, sensor, 2)
    got, reads = _host_reads(tinteg.render_pass, scene, camera, cfg, flt,
                             sensor, torch.tensor(2),
                             monkeypatch=monkeypatch)
    assert reads == [], reads
    assert float(want[0].max()) > 0.0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def canonical_small():
    """The canonical frame at 48x48, spp 6 (a 2 x 3 stratified grid: the
    walk runs), on a small stand-in (the octree path; it covers a few
    pixels)."""
    mesh = tmesh_gen.dragon_stand_in(target_tris=2000)
    return entry.canonical_setup(48, 6, mesh=mesh, device="cpu")


def test_canonical_pass_tensor_index(canonical_small, monkeypatch):
    """canonical_pass on a tensor index equals the int index's bit for bit
    and reads nothing back to the host (the octree scene's path)."""
    scene, camera, cfg = canonical_small
    sensor = tsen.PixelSensor.create()
    for s in (0, 5):
        want = entry.canonical_pass(scene, camera, cfg, sensor, s)
        got, reads = _host_reads(entry.canonical_pass, scene, camera, cfg,
                                 sensor, torch.tensor(s),
                                 monkeypatch=monkeypatch)
        assert reads == [], reads
        assert float(want[0].max()) > 0.0
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_canonical_render_accumulates_passes(canonical_small):
    """canonical_render on the CPU (the eager loop) equals the films of
    canonical_pass added one by one (Film.add_aligned) bit for bit."""
    scene, camera, cfg = canonical_small
    sensor = tsen.PixelSensor.create()
    _, film = entry.canonical_render(48, 6, scene=scene)
    want = None
    for s in range(6):
        rgb, wt = entry.canonical_pass(scene, camera, cfg, sensor, s)
        want = (tinteg.filmmod.Film.create((48, 48)) if want is None
                else want).add_aligned(rgb, wt)
    assert film.spp_done == 6
    assert torch.equal(film.rgb_sum, want.rgb_sum)
    assert torch.equal(film.weight_sum, want.weight_sum)


@pytest.mark.parametrize("kind", ["stratified", "sobol_global"])
def test_index_bumped_in_place_equals_int_loop(kind):
    """A pass that reads its index from one tensor bumped in place after
    each pass (what a pass_graph replay does), summed as the graph sums,
    equals render_passes over Python ints bit for bit; so does render()."""
    scene, camera, cfg = _cornell(kind)
    flt, sensor = tinteg.make_filter(cfg), tsen.PixelSensor.create()
    want = tinteg.render_passes(scene, camera, cfg, flt, sensor, 0, 4)
    idx = torch.zeros((), dtype=torch.int64)
    rgb_sum, wt_sum = torch.zeros((16, 16, 3)), torch.zeros((16, 16))
    for _ in range(4):
        rgb, wt = tinteg.render_pass(scene, camera, cfg, flt, sensor, idx)
        rgb_sum.add_(rgb * wt[..., None])
        wt_sum.add_(wt)
        idx.add_(1)
    assert int(idx) == 4
    assert torch.equal(rgb_sum, want[0]) and torch.equal(wt_sum, want[1])
    film, _ = tinteg.render(scene, camera, cfg, passes=4, chunk=4)
    assert torch.equal(film.rgb_sum, want[0])
    assert torch.equal(film.weight_sum, want[1])


@pytest.mark.cuda
def test_captured_cornell_pass_on_cuda():
    """Needs a CUDA card and nvcc: a Cornell pass at 64x64 captured by
    pass_graph; each replay's sums equal the eager pass's bit for bit, and
    render() (captured) equals the eager loop (accumulate without capture)
    with the same launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a CUDA graph is captured only on the "
                    "card")
    scene, camera, cfg = entry.cornell_setup(res=64, spp=4, device="cuda")
    flt, sensor = tinteg.make_filter(cfg), tsen.PixelSensor.create()
    one_pass = lambda i: tinteg.render_pass(scene, camera, cfg, flt, sensor,
                                            i)
    with torch.no_grad():
        one_pass(0)
        graph = tinteg.pass_graph(one_pass, 1, cfg.resolution, scene.device)
        for s in (1, 2, 3):
            got = [x.clone() for x in tinteg.replay_sums(graph, 1)]
            want = tinteg.render_passes(scene, camera, cfg, flt, sensor, s, 1)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    films, counts = [], []
    for run in (lambda: tinteg.render(scene, camera, cfg, chunk=2)[0],
                lambda: tinteg.accumulate(
                    one_pass, tinteg.filmmod.Film.create((64, 64), "cuda"),
                    4, 2)):
        before = graphs.launch_counts()
        with torch.no_grad():
            films.append(run())
        counts.append({k: n - before[k]
                       for k, n in graphs.launch_counts().items()})
    assert counts[0] == counts[1] and counts[0]["brute_closest"] > 0
    assert torch.equal(films[0].rgb_sum, films[1].rgb_sum)
    assert torch.equal(films[0].weight_sum, films[1].weight_sum)
