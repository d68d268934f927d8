"""The captured pass ``render()`` keeps across calls
(``integrator.KeptPass``), and the sampler's device seed it replays with.

On the CPU: the key (``integrator.kept_key``) as a plain function, equal
for configs that differ only in the seed and different for every other
change a graph cannot take; no key for a compacted render or a CPU scene;
``render()`` on a CPU scene bit for bit the eager loop, keeping nothing;
the word the host writes into a device seed against ``draw_params``; the
plain draws on a tensor seed bit for bit those on the int; and the whole
kept route with a CUDA graph stood in for by one that runs its function at
each replay (as ``test_torch_tracing.py`` does): a new seed and a resumed
film replay the kept graph and give the eager loop's bits, a new camera,
a rebound scene tensor or another scene captures anew and releases the old
graph (one pass is kept at a time), and a call under a profiler leaves the
kept pass alone.

On the card (``cuda``-marked; skip without one): a second ``render()``
with a new seed replays the kept CUDA graph, bit for bit the eager loop
with the same launches, also after the camera's frame cache is cleared
and the allocator churned; the scene's collection releases the graph."""

import contextlib
import dataclasses
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.ops import camera as cam
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops import rng
from computational_ray_tracer_tpu_torch.ops import rng_kernel as rk
from computational_ray_tracer_tpu_torch.utils import metrics

RES, SPP = 12, 4
CARD = torch.device("cuda", 0)
SAMPLERS = {
    "independent": dict(kind="independent", spp=SPP),
    "stratified": dict(kind="stratified", spp=SPP, xs=2, ys=2),
    "sobol": dict(kind="sobol", spp=SPP),
    "sobol_global": dict(kind="sobol_global", spp=SPP),
}
SEEDS = (0, 1, (1 << 31) - 1, (1 << 32) + 5, -7)


@pytest.fixture
def cornell():
    return entry.cornell_setup(res=RES, spp=SPP, device="cpu")


def _with(cfg, **sampler):
    return dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler, **sampler))


def _sampler(cfg, kind, seed):
    return dataclasses.replace(cfg, sampler=integ.SamplerConfig(
        **SAMPLERS[kind], seed=seed))


@pytest.mark.parametrize("kind", ["sobol", "stratified", "independent"])
def test_key_ignores_the_seed(cornell, kind):
    """Configs that differ only in the seed share a key: the graph reads
    the seed from the device."""
    scene, camera, cfg = cornell
    keys = [integ.kept_key(scene, camera, _sampler(cfg, kind, seed), CARD)
            for seed in SEEDS]
    assert keys[0] is not None
    assert all(k == keys[0] for k in keys)


def _rebind(scene):
    scene.materials.albedo_coeffs = scene.materials.albedo_coeffs.clone()


# Each change a kept graph cannot take: (what it changes, on the config,
# the camera or the scene).
CHANGES = {
    "camera": lambda s, c, f: (s, dataclasses.replace(
        c, position=(0.0, 1.0, -3.0)), f),
    "resolution": lambda s, c, f: (s, c, dataclasses.replace(
        f, resolution=(RES, RES + 2))),
    "integrator": lambda s, c, f: (s, c, dataclasses.replace(
        f, integrator="simple")),
    "max_depth": lambda s, c, f: (s, c, dataclasses.replace(f, max_depth=2)),
    "filter": lambda s, c, f: (s, c, dataclasses.replace(
        f, filter_name="box")),
    "lambda_mode": lambda s, c, f: (s, c, dataclasses.replace(
        f, lambda_mode="uniform")),
    "spp": lambda s, c, f: (s, c, _with(f, spp=SPP + 4)),
    "sampler_kind": lambda s, c, f: (s, c, _with(f, kind="independent")),
    "scene_value": lambda s, c, f: (dataclasses.replace(s, wr=s.wr * 2),
                                    c, f),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_key_changes(cornell, change):
    scene, camera, cfg = cornell
    want = integ.kept_key(scene, camera, cfg, CARD)
    assert integ.kept_key(*CHANGES[change](scene, camera, cfg),
                          CARD) != want


def test_key_changes_with_a_rebound_tensor(cornell):
    """A scene field rebound to another tensor (equal values) changes the
    key: the graph reads the old one's address."""
    scene, camera, cfg = cornell
    want = integ.kept_key(scene, camera, cfg, CARD)
    _rebind(scene)
    assert integ.kept_key(scene, camera, cfg, CARD) != want


def test_key_holds_the_layout(cornell):
    """The layout a graph was captured on (the sharded step's mesh) is part
    of the key; render()'s is empty."""
    scene, camera, cfg = cornell
    key = lambda layout=(): integ.kept_key(scene, camera, cfg, CARD, layout)
    assert key() == key(()) != key(("dp", "sp")) == key(["dp", "sp"])
    assert key()[-1] == ()


def test_key_keeps_a_sobol_global_seed(cornell):
    """sobol_global draws take an int seed: another seed is another key,
    the same seed the same key."""
    scene, camera, cfg = cornell
    key = lambda seed: integ.kept_key(
        scene, camera, _sampler(cfg, "sobol_global", seed), CARD)
    assert key(3) == key(3) != key(4)


@pytest.mark.parametrize("route", ["compact", "cpu", "profiler"])
def test_no_key(cornell, route):
    """No key for a compacted render, a CPU scene, or while a profiler
    records."""
    scene, camera, cfg = cornell
    device = scene.device if route == "cpu" else CARD
    if route == "compact":
        cfg = dataclasses.replace(cfg, compact=True)
    with (profile(activities=[ProfilerActivity.CPU]) if route == "profiler"
          else contextlib.nullcontext()):
        assert integ.kept_key(scene, camera, cfg, device) is None


def _eager(scene, camera, cfg, film=None, stop=None, chunk=1):
    """The eager loop of render() (accumulate without capture)."""
    flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
    with torch.no_grad():
        return integ.accumulate(
            lambda i: integ.render_pass(scene, camera, cfg, flt, sensor, i),
            film or filmmod.Film.create(cfg.resolution, device=scene.device),
            stop or cfg.sampler.spp, chunk)


def _same(a, b):
    return (torch.equal(a.rgb_sum, b.rgb_sum)
            and torch.equal(a.weight_sum, b.weight_sum)
            and a.spp_done == b.spp_done)


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_cpu_render_is_the_eager_loop(cornell, kind):
    """render() on a CPU scene runs the eager loop, bit for bit, and
    keeps nothing."""
    scene, camera, cfg = cornell
    cfg = _sampler(cfg, kind, 12345)
    metrics.reset()
    film, _ = integ.render(scene, camera, cfg, chunk=2)
    assert _same(film, _eager(scene, camera, cfg, chunk=2))
    assert float(film.rgb_sum.max()) > 0.0
    assert integ._KEPT is None
    assert not any(name.startswith("crt.graph")
                   for name in metrics.counters())


@pytest.mark.parametrize("seed", SEEDS)
def test_device_seed_words(seed):
    """The word the host writes for a device seed is draw_params' seed,
    and the hash every lane takes of either (hash_step from hash_u32's
    initial word) is hash_u32 of the int seed."""
    for kind in rk.KINDS:
        p = rk.draw_params(kind, seed, 5, 32, 4, 8, True, True)
        word = rk.seed_word(seed)
        assert word == p.seed
        on_card = rng.mix_bits(0x9E3779B9 ^ rng._mul(word, 0x01000193))
        assert on_card == rng.hash_u32(seed) == int(rng.hash_u32(
            torch.tensor(word)))


@pytest.mark.parametrize("kind,two_d", [(k, t) for k in rk.KINDS
                                        for t in (False, True)])
def test_plain_draws_on_a_tensor_seed(kind, two_d):
    """The plain route (CPU pixels) on a 0-d tensor holding seed_word(seed)
    gives the int seed's draws bit for bit."""
    pixel = torch.arange(300, dtype=torch.int64)
    draw = lambda s: (rk.draw_2d(kind, s, pixel, 3, 5, 7, 7, 1) if two_d
                      else rk.draw_1d(kind, s, pixel, 3, 5, 7))
    for seed in SEEDS:
        dev_seed = torch.tensor(rk.seed_word(seed), dtype=torch.int64)
        assert torch.equal(draw(dev_seed), draw(seed)), seed


class _Graph:
    """A stand-in for a CUDA graph on the CPU: the capture keeps the
    function, each replay runs it; resets are counted."""
    resets = 0

    def __init__(self):
        self.fn = None

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None
        _Graph.resets += 1


def _capture(graph, fn, pool=None):
    graph.fn = fn
    return None, {}


@pytest.fixture
def stand_in(monkeypatch):
    """render()'s kept route on a CPU scene: kept_key as on the card, and
    every capture into a _Graph."""
    key = integ.kept_key
    monkeypatch.setattr(integ, "kept_key",
                        lambda scene, camera, cfg, device, layout=(): key(
                            scene, camera, cfg, CARD, layout))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(graphs, "capture", _capture)
    monkeypatch.setattr(graphs, "device_allocs", lambda device: (0, 0))
    _Graph.resets = 0
    yield
    if integ._KEPT is not None:
        integ._forget(integ._KEPT)


def _render(scene, camera, cfg, **kw):
    """render() and the crt.graph.* counters of its frame."""
    metrics.reset()
    film, _ = integ.render(scene, camera, cfg, **kw)
    return film, {name: n for name, n in metrics.counters().items()
                  if name.startswith("crt.graph")}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_kept_route_on_a_stand_in_graph(cornell, stand_in, kind):
    """The first call captures; a call with a new seed replays the kept
    graph (every pass, none eager), the eager loop's bits at that seed;
    sobol_global, whose seed is in the key, captures anew for a new seed
    and replays for the same one."""
    scene, camera, cfg = cornell
    c0, c1 = _sampler(cfg, kind, 11), _sampler(cfg, kind, (1 << 31) + 9)
    film, got = _render(scene, camera, c0, chunk=3)
    assert got == {"crt.graph.captured": 1}
    assert _same(film, _eager(scene, camera, c0, chunk=3))
    film, got = _render(scene, camera, c1, chunk=3)
    want = "crt.graph.captured" if kind == "sobol_global" else \
        "crt.graph.kept"
    assert got == {want: 1}
    assert _same(film, _eager(scene, camera, c1, chunk=3))
    assert not _same(film, _eager(scene, camera, c0, chunk=3))
    film, got = _render(scene, camera, c1)
    assert got == {"crt.graph.kept": 1}
    assert _same(film, _eager(scene, camera, c1))
    assert _Graph.resets == (1 if kind == "sobol_global" else 0)


def test_resume_replays_the_kept_graph(cornell, stand_in):
    """render(film=, passes=) in a loop, as the reference's resume: the
    first call captures, the others replay from the film's spp_done."""
    scene, camera, cfg = cornell
    film, got = _render(scene, camera, cfg, passes=2)
    assert got == {"crt.graph.captured": 1}
    counts = []
    for _ in range(2):
        film, got = _render(scene, camera, cfg, film=film, passes=1)
        counts.append(got)
    assert counts == [{"crt.graph.kept": 1}] * 2
    assert _same(film, _eager(scene, camera, cfg))


def test_one_pass_keeps_nothing(cornell, stand_in):
    """A call of one pass captures nothing, so it keeps nothing."""
    scene, camera, cfg = cornell
    film, got = _render(scene, camera, cfg, passes=1)
    assert got == {} and integ._KEPT is None
    assert _same(film, _eager(scene, camera, cfg, stop=1))


@pytest.mark.parametrize("change", ["camera", "rebound"])
def test_a_new_key_captures_anew(cornell, stand_in, change):
    """A new camera or a rebound scene tensor misses: the call captures a
    new graph, keeps it in place of the old, and releases the old one."""
    scene, camera, cfg = cornell
    _render(scene, camera, cfg)
    old = integ._KEPT
    if change == "camera":
        camera = dataclasses.replace(camera, position=(0.0, 1.0, -3.0))
    else:
        _rebind(scene)
    film, got = _render(scene, camera, cfg)
    assert got == {"crt.graph.captured": 1} and _Graph.resets == 1
    assert integ._KEPT is not old
    assert _same(film, _eager(scene, camera, cfg))
    _, got = _render(scene, camera, cfg)
    assert got == {"crt.graph.kept": 1}


def test_kept_pass_pins_the_camera_frame(cornell, stand_in):
    """The kept pass holds the camera's frame tensors, which sit in a
    bounded cache: clearing the cache leaves the replays' inputs alive."""
    scene, camera, cfg = cornell
    _render(scene, camera, cfg)
    frame = camera.frame(scene.device)
    assert integ._KEPT.pins[1] is frame
    cam._frame.cache_clear()
    film, got = _render(scene, camera, cfg)
    assert got == {"crt.graph.kept": 1}
    assert _same(film, _eager(scene, camera, cfg))


def test_one_pass_is_kept_at_a_time(stand_in):
    """render() keeps one pass, the last key's: a call on a second scene
    releases the first scene's graph, and the first scene captures anew."""
    a = entry.cornell_setup(res=RES, spp=SPP, device="cpu")
    b = entry.cornell_setup(res=RES, spp=SPP, device="cpu")
    _render(*a)
    kept_a = integ._KEPT
    film, got = _render(*b)
    assert got == {"crt.graph.captured": 1} and _Graph.resets == 1
    assert integ._KEPT is not kept_a and not kept_a.finalizer.alive
    assert _same(film, _eager(*b))
    film, got = _render(*a)
    assert got == {"crt.graph.captured": 1} and _Graph.resets == 2
    assert _same(film, _eager(*a))


def test_a_profiled_call_leaves_the_kept_pass(cornell, stand_in):
    """A call made while a profiler records neither replays nor replaces
    the kept pass: it runs the route of a call with no kept pass (its own
    eager pass, for the fine spans and counters), the same bits; the call
    after it replays the kept graph."""
    scene, camera, cfg = cornell
    _render(scene, camera, cfg)
    kept = integ._KEPT
    c = _with(cfg, seed=99)
    with profile(activities=[ProfilerActivity.CPU]):
        film, got = _render(scene, camera, c)
    assert got == {} and integ._KEPT is kept and _Graph.resets == 0
    assert _same(film, _eager(scene, camera, c))
    assert metrics.counters()["crt.bounce.lanes"] > 0
    film, got = _render(scene, camera, c)
    assert got == {"crt.graph.kept": 1}
    assert _same(film, _eager(scene, camera, c))


def test_scene_collection_releases_the_graph(stand_in):
    """The kept pass holds its scene weakly: the scene's collection drops
    it and releases its graph."""
    scene, camera, cfg = entry.cornell_setup(res=RES, spp=SPP, device="cpu")
    _render(scene, camera, cfg)
    kept = integ._KEPT
    assert kept.finalizer.peek()[0] is scene
    kept.graph.graph.fn = None   # the stand-in's hold on the pass
    del scene
    gc.collect()
    assert integ._KEPT is None and _Graph.resets == 1
    assert not kept.finalizer.alive


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _counted(fn):
    before = graphs.launch_counts()
    with torch.no_grad():
        film = fn()
    return film, {k: n - before[k] for k, n in graphs.launch_counts().items()}


@pytest.mark.cuda
def test_render_keeps_its_pass_on_cuda():
    """Needs a CUDA card and nvcc: a 64x64 Cornell render() captures; one
    with a new seed replays the kept graph, bit for bit the eager loop at
    that seed with the same launches, also after the camera's frame cache
    is cleared and the allocator churned; the scene's collection releases
    the graph."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a CUDA graph is captured only on the "
                    "card")
    scene, camera, cfg = entry.cornell_setup(res=64, spp=4, device="cuda")
    _render(scene, camera, cfg)
    for seed in (7, (1 << 32) + 5):
        c = _with(cfg, seed=seed)
        cam._frame.cache_clear()
        churn = [torch.empty(1 << k, device="cuda") for k in range(10, 24)]
        del churn
        metrics.reset()
        (film, _), got = _counted(lambda: integ.render(scene, camera, c))
        assert metrics.counters().get("crt.graph.kept") == 1
        want, counts = _counted(lambda: _eager(scene, camera, c))
        assert got == counts and got["sampler"] > 0
        assert _same(film, want)
    assert integ._KEPT is not None
    del scene, film
    gc.collect()
    assert integ._KEPT is None
