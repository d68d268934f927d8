"""The port's one CUDA-graph class (``models/graphs.py``) on the CPU, its
graph stood in for by one that runs the captured function at each replay,
under each of the closures the port captures: the pass graph
(``integrator.pass_graph``: the sums in ``render_passes``' order, the
index stepped by one), the sharded render step (``integrator.capture_sums``
of already-weighted sums, the index stepped by n_sp, into the kept pool it
is given) and the sharded train step (``sharding.train_graph`` through
``TrainStep``'s routes: the target and the index copied into its static
inputs, no host read). Each replay adds the capture's launches. The
captures themselves run on the card only (the ``cuda``-marked tests of
the callers' files, and ``chip_smoke.py`` phases 16, 23 and 24)."""

import types

import pytest
import torch

from test_torch_device_index import _HostReads
from test_torch_tracing import _Graph, _capture
from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models import inverse as inv
from computational_ray_tracer_tpu_torch.parallel import sharding as par

RES, N_SP, LAUNCHES = 8, 2, {"interp": 2, "sampler": 5}


@pytest.fixture
def stand_in(monkeypatch):
    """Every capture into a _Graph, counting LAUNCHES; the pools it was
    given, and the launch counters restored after the test."""
    pools = []

    def capture(graph, fn, pool=None):
        pools.append(pool)
        return _capture(graph, fn)[0], dict(LAUNCHES)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "device_allocs", lambda device: (0, 0))
    monkeypatch.setattr(graphs, "on_side_stream", lambda fn: fn())
    for mod, attr in graphs.LAUNCH_COUNTERS.values():
        monkeypatch.setattr(mod, attr, getattr(mod, attr))
    return pools


def _replays_count(before, n):
    after = graphs.launch_counts()
    return all(after[k] - before[k] == n * LAUNCHES.get(k, 0) for k in after)


def _pass_route(pools, monkeypatch):
    scene, camera, cfg = entry.cornell_setup(res=RES, spp=8, device="cpu")
    flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
    one_pass = lambda i: integ.render_pass(scene, camera, cfg, flt, sensor,
                                           i)
    graph = integ.pass_graph(one_pass, 2, cfg.resolution, scene.device)
    before = graphs.launch_counts()
    got = [x.clone() for x in integ.replay_sums(graph, 3)]
    assert _replays_count(before, 3)
    want = integ.render_passes(scene, camera, cfg, flt, sensor, 2, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(graph.idx) == 5 and pools == [None]
    # Onto given sums, from an index set anew (an int, then a tensor).
    more = list(want)
    for i in (6, 7):
        rgb, wt = one_pass(i)
        more = [more[0] + rgb * wt[..., None], more[1] + wt]
    for start in (6, torch.tensor(6)):
        graph.set_index(start)
        got = integ.replay_sums(graph, 2, *want)
        assert all(torch.equal(a, b) for a, b in zip(got, more))
        assert int(graph.idx) == 8


def _sharded_route(pools, monkeypatch):
    """A step of N_SP already-weighted passes (the sp sum of a sharded
    step), captured into the card's kept pool."""
    scene, camera, cfg = entry.cornell_setup(res=RES, spp=8, device="cpu")
    flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)

    def step_sums(idx):
        return integ.render_passes(scene, camera, cfg, flt, sensor, idx,
                                   N_SP)

    pool = object()
    monkeypatch.setattr(graphs, "kept_pool", lambda device: pool)
    graph = integ.capture_sums(step_sums, N_SP, N_SP, cfg.resolution,
                               scene.device, kept=True)
    first = step_sums(0)
    before = graphs.launch_counts()
    got = integ.replay_sums(graph, 3, *first)
    assert _replays_count(before, 3) and pools == [pool]
    want = list(first)
    for base in (2, 4, 6):
        want = [a + b for a, b in zip(want, step_sums(base))]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(graph.idx) == N_SP + 3 * N_SP


def _train_route(pools, monkeypatch):
    """TrainStep's routes (warm-up, capture, then replays) against its
    eager route, on a step whose loss reads the target and the index."""
    def eager(params, opt, scene, target, idx):
        opt.zero_grad()
        p = params["p"]
        loss = torch.mean((p * (integ.sample_index(idx, p.device) + 1)
                           - target) ** 2)
        p.grad, = torch.autograd.grad(loss, [p])
        opt.step()
        return loss.detach()

    scene = types.SimpleNamespace(device=torch.device("cpu"))
    targets = [torch.linspace(0, 1, 6) * (k + 1) for k in range(5)]
    indices = [0, 1, torch.tensor(2), 3, torch.tensor(4)]
    runs = {}
    for captured in (True, False):
        step = par.TrainStep(eager, captured)
        params = {"p": torch.ones(6, requires_grad=True)}
        opt = inv.DeviceAdam([params["p"]], lr=0.1)
        losses, routes, reads = [], [], []
        for target, idx in zip(targets, indices):
            before = graphs.launch_counts()
            mode = _HostReads()
            with mode:
                _, _, loss = step(params, opt, scene, target, idx)
            replayed = step.route in ("capture", "replay")
            assert _replays_count(before, int(replayed))
            reads += mode.seen if replayed else []
            losses.append(loss)
            routes.append(step.route)
        runs[captured] = losses, params["p"].detach()
        if captured:
            assert routes == ["warm-up", "capture", "replay", "replay",
                              "replay"]
            assert reads == [] and pools == [None]
            assert torch.equal(step.graph.state[0], targets[-1])
    (l0, p0), (l1, p1) = runs[True], runs[False]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert torch.equal(p0, p1)


@pytest.mark.parametrize("route", [_pass_route, _sharded_route,
                                   _train_route],
                         ids=["pass", "sharded", "train"])
def test_captured_graph_on_a_stand_in(stand_in, monkeypatch, route):
    route(stand_in, monkeypatch)
