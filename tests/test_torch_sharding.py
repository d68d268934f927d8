"""The port's sharded render and train step (``parallel/sharding.py``)
against its own single-process render and gradient and against the JAX
package's sharded path on the 8-CPU mesh: the counterparts of the seven
tests of ``tests/test_sharding.py`` at their tolerances, plus the film's
scatter/merge, the ranks' scene bits, the default optimizer (DeviceAdam)
against the JAX ``make_train_step``'s optax.adam, and what the captured
routes on NCCL need: no host read in either step on a device index (a
one-rank gloo world in the test process) and the train step's route as a
plain decision. The captures themselves run on the card only (the
``cuda``-marked test, and ``chip_smoke.py`` phase 16).

The ranks are gloo processes on the CPU, started with
``torch.multiprocessing`` (spawn, ``chip_smoke.spawn_ranks``: killed past
300 s) over a ``file://`` store under the test's temporary directory, one
thread each. One spawn of 8 ranks runs every case
of the layouts (8, 1), (4, 2) and (2, 4), each its own DeviceMesh over the
same 8 ranks; one spawn of 1 rank runs (1, 1). Each rank writes its results
to a file. The scenes are the JAX package's, exported as numpy arrays and
rebuilt by every rank with ``convert.scene_from_numpy``, so both packages
render bit-identical parameters. JAX is imported by the tests only, never
by the ranks.
"""

import contextlib
import dataclasses
import gc
import os
import types
import weakref

import numpy as np
import pytest
import torch

from chip_smoke import spawn_ranks
from computational_ray_tracer_tpu_torch import convert
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.models import inverse as tinv
from computational_ray_tracer_tpu_torch.ops import camera as tcam
from computational_ray_tracer_tpu_torch.ops import film as tfilm
from computational_ray_tracer_tpu_torch.parallel import sharding as par
from computational_ray_tracer_tpu_torch.utils import metrics

LAYOUTS = [(8, 1), (4, 2), (2, 4), (1, 1)]
INTEGRATORS = ["direct", "walk", "simple", "path"]
GRAD_LAYOUTS = {1: (8, 1), 2: (4, 2), 4: (2, 4)}     # n_sp -> layout
ADAM_LAYOUTS = [(1, 1), (4, 2)]


def _camera(res):
    return tcam.PerspectiveCamera.create((0, 0, -4), (res, res), fov_y=40.0,
                                         look_at=(0, 0, 0))


def _cfg(res, spp, **kw):
    """``tests/test_sharding.py``'s cfg, in the port (or ``mod``)."""
    mod = kw.pop("mod", tinteg)
    return dataclasses.replace(mod.RenderConfig(
        resolution=(res, res),
        sampler=mod.SamplerConfig(kind="sobol", spp=spp),
        integrator="direct"), **kw)


def _octree_cfg(mod=tinteg):
    return mod.RenderConfig(
        resolution=(16, 16), sampler=mod.SamplerConfig(kind="sobol", spp=2),
        integrator="path", max_depth=3)


def _independent_cfg(spp):
    """The 16x16 direct cfg with the independent sampler, whose draws take
    any sample index (the sobol and stratified permutations hang for an
    index >= spp when spp is not a power of two, in both packages)."""
    return dataclasses.replace(_cfg(16, spp), sampler=tinteg.SamplerConfig(
        kind="independent", spp=spp))


def _cases(n_dp, n_sp):
    """The cases a layout runs: (name, scene key, config)."""
    cases = [("film", "sphere16", _cfg(16, 4))]
    if (n_dp, n_sp) == (4, 2):
        cases += [(f"integrator_{i}", "sphere16",
                   _cfg(16, 2, integrator=i, max_depth=3))
                  for i in INTEGRATORS]
        cases.append(("octree", "cornell16", _octree_cfg()))
        cases.append(("spp3", "sphere16", _independent_cfg(3)))
    return cases


def _grad(scene, mesh, sample_idx=0):
    """The sharded albedo gradient of the direct 8x8 loss against 0.1."""
    cfg = _cfg(8, 2)
    step, init, _ = par.make_train_step(
        scene, _camera(8), cfg, mesh, tinv.albedo_params(scene),
        optimizer=lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    params = tinv.leaf_params(tinv.albedo_params(scene)[0](scene))
    _, _, loss = step(params, init(params), scene, torch.full((8, 8, 3), 0.1),
                      sample_idx)
    return {"grad": params["albedo_coeffs"].grad.clone(), "loss": float(loss)}


def _train(scene, mesh):
    """8 Adam steps of the path/MIS depth-2 8x8 loss against black."""
    cfg = _cfg(8, 2, integrator="path", max_depth=2)
    extract_insert = tinv.albedo_params(scene)
    step, init, _ = par.make_train_step(scene, _camera(8), cfg, mesh,
                                        extract_insert)
    params = tinv.leaf_params(extract_insert[0](scene))
    p0 = params["albedo_coeffs"].detach().clone()
    opt = init(params)
    losses = []
    for i in range(8):
        params, opt, loss = step(params, opt, scene, torch.zeros((8, 8, 3)),
                                 i * 2)
        losses.append(float(loss))
    return {"losses": losses, "p0": p0,
            "p1": params["albedo_coeffs"].detach().clone()}


def _adam(scene, mesh):
    """3 steps of make_train_step with its default optimizer on the direct
    8x8 albedo loss against 0.1, at samples 0, n_sp and 2 n_sp: each
    step's loss, the parameters after it and its route."""
    n_sp = mesh.size(1)
    extract_insert = tinv.albedo_params(scene)
    step, init, _ = par.make_train_step(scene, _camera(8), _cfg(8, 2), mesh,
                                        extract_insert)
    params = tinv.leaf_params(extract_insert[0](scene))
    opt = init(params)
    out = {"optimizer": type(opt).__name__, "losses": [], "params": [],
           "routes": []}
    for i in range(3):
        params, opt, loss = step(params, opt, scene,
                                 torch.full((8, 8, 3), 0.1), i * n_sp)
        out["losses"].append(float(loss))
        out["params"].append(params["albedo_coeffs"].detach().clone())
        out["routes"].append(step.route)
    return out


def _frame_record(first):
    """The spans a rank recorded after span id ``first`` (name, request,
    parent) and the counters of its ``crt.frame``'s request."""
    spans = [s for s in metrics.spans() if s["id"] > first]
    roots = [s for s in spans if s["name"] == "crt.frame"]
    return {"spans": [(s["name"], s["request"], s["parent"]) for s in spans],
            "root": roots[0]["id"] if roots else None,
            "counters": metrics.counters(roots[0]["request"]) if roots
            else {}}


def _rank_main(rank, world, tmp):
    """One rank: join the group, rebuild the scenes, run every layout of
    this world size, write the results to tmp/rank<rank>_<world>.pt."""
    torch.set_num_threads(1)
    out = {"init": par.init_distributed(
        "file://" + os.path.join(tmp, f"store{world}"), world, rank,
        device_type="cpu")}
    arrays, cornell_camera = torch.load(os.path.join(tmp, "scenes.pt"),
                                        weights_only=False)
    scenes = {k: convert.scene_from_numpy(v, "cpu") for k, v in
              arrays.items()}
    out["digest"] = {k: par.scene_digest(s) for k, s in scenes.items()}
    try:
        par.make_mesh(n_dp=world, n_sp=2, device_type="cpu")
    except ValueError as err:
        out["too_large"] = str(err)
    if world > 1:
        out["global_mesh"] = tuple(par.global_mesh(
            n_sp=2, device_type="cpu").mesh.shape)
    for n_dp, n_sp in [lay for lay in LAYOUTS if lay[0] * lay[1] == world]:
        mesh = par.make_mesh(n_dp, n_sp, device_type="cpu")
        res = out[(n_dp, n_sp)] = {"shape": tuple(mesh.mesh.shape)}
        for name, key, cfg in _cases(n_dp, n_sp):
            first = metrics.RECORDER.last_id
            film, _ = par.render_distributed(
                scenes[key], _camera(16) if key == "sphere16"
                else cornell_camera, cfg, mesh)
            res[name] = film
            if name == "film":
                res["frame_record"] = _frame_record(first)
        if (n_dp, n_sp) in GRAD_LAYOUTS.values():
            res["grad"] = _grad(scenes["sphere8"], mesh)
        if n_dp > 1:
            try:         # 9 x 9 pixels do not split over dp
                par.make_sharded_render(scenes["sphere16"], _camera(9),
                                        _cfg(9, 1), mesh)
            except ValueError as err:
                res["uneven"] = str(err)
        if (n_dp, n_sp) == (4, 2):
            res["train"] = _train(scenes["sphere8"], mesh)
        if (n_dp, n_sp) in ADAM_LAYOUTS:
            res["adam"] = _adam(scenes["sphere8"], mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}_{world}.pt"))


# ---------------------------------------------------------------------------
# The JAX side (imported here, in the test process only)
# ---------------------------------------------------------------------------

def _jax_scenes():
    from __graft_entry__ import _cornell_setup
    from test_sharding import scene_and_camera
    sphere16, jcam16 = scene_and_camera(16)
    sphere8, jcam8 = scene_and_camera(8)
    cornell, ccam, _ = _cornell_setup(res=16, spp=2, use_octree=True,
                                      use_pallas=True)
    return {"sphere16": (sphere16, jcam16), "sphere8": (sphere8, jcam8),
            "cornell16": (cornell, ccam)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the 8-rank and the 1-rank worlds once; returns (the JAX
    scenes, the port's scenes, {world: [each rank's results]})."""
    from test_torch_render import export_scene
    tmp = str(tmp_path_factory.mktemp("ranks"))
    jscenes = _jax_scenes()
    arrays = {k: export_scene(s) for k, (s, _) in jscenes.items()}
    c = jscenes["cornell16"][1]
    cornell_camera = tcam.PerspectiveCamera(
        c.position, c.basis, c.resolution, c.fov_y, c.lens_radius,
        c.focal_distance)
    torch.save((arrays, cornell_camera), os.path.join(tmp, "scenes.pt"))
    results = {}
    for n in (8, 1):
        spawn_ranks(_rank_main, (n, tmp), n, timeout_s=300)
        results[n] = [torch.load(os.path.join(tmp, f"rank{r}_{n}.pt"),
                                 weights_only=False) for r in range(n)]
    tscenes = {k: convert.scene_from_numpy(arrays[k], "cpu")
               for k in jscenes}
    return jscenes, tscenes, cornell_camera, results


def _layout(world, n_dp, n_sp):
    """Every rank's results for a layout."""
    return [r[(n_dp, n_sp)] for r in world[3][n_dp * n_sp]]


def _render(world, key, cfg):
    tscene = world[1][key]
    camera = _camera(16) if key == "sphere16" else world[2]
    return tinteg.render(tscene, camera, cfg)[0]


def _assert_film(ranks, name, ref, rtol, atol):
    for r in ranks:
        film = r[name]
        np.testing.assert_allclose(film.rgb_sum.numpy(), ref.rgb_sum.numpy(),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(film.weight_sum.numpy(),
                                   ref.weight_sum.numpy(), rtol=rtol,
                                   atol=atol)
        assert film.spp_done == ref.spp_done


def test_mesh_construction(world):
    """A (dp, sp) mesh over the world; ValueError naming the devices when
    the mesh is larger than the world (8 ranks asked for 8x2, 1 rank for
    1x2)."""
    for n, ranks in world[3].items():
        for r in ranks:
            assert "devices" in r["too_large"], r["too_large"]
    for n_dp, n_sp in LAYOUTS:
        for r in _layout(world, n_dp, n_sp):
            assert r["shape"] == (n_dp, n_sp)


def test_make_mesh_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        par.make_mesh(1, 1, device_type="cuda")


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_sharded_matches_single_device_all_integrators(world, integrator):
    """Every integrator goes through the one dispatch of render_pass:
    the (4, 2) film equals the single-process render()."""
    cfg = _cfg(16, 2, integrator=integrator, max_depth=3)
    _assert_film(_layout(world, 4, 2), f"integrator_{integrator}",
                 _render(world, "sphere16", cfg), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("n_dp,n_sp", LAYOUTS)
def test_sharded_matches_single_device(world, n_dp, n_sp):
    """Any layout gives the single-process film (placement-invariant
    samples)."""
    _assert_film(_layout(world, n_dp, n_sp), "film",
                 _render(world, "sphere16", _cfg(16, 4)), rtol=1e-5,
                 atol=2e-6)


def test_render_distributed_steps_past_spp_as_the_reference(world):
    """spp 3 over n_sp 2 renders samples 0-3 (the reference's loop over
    range(0, spp, n_sp)): the film is render()'s at spp 4; and a pixel
    count that does not split over dp raises."""
    _assert_film(_layout(world, 4, 2), "spp3",
                 _render(world, "sphere16", _independent_cfg(4)), rtol=1e-5,
                 atol=2e-6)
    for n_dp, n_sp in LAYOUTS[:3]:
        for r in _layout(world, n_dp, n_sp):
            assert "do not split" in r["uneven"]


def test_sharded_matches_jax_render_distributed(world):
    """The port's (4, 2) film against the JAX package's render_distributed
    on the (4, 2) mesh of 8 CPU devices, atol 2e-3*max."""
    import jax
    from computational_ray_tracer_tpu.models import integrator as jinteg
    from computational_ray_tracer_tpu.parallel import sharding as jpar
    jscene, jcamera = world[0]["sphere16"]
    mesh = jpar.make_mesh(n_dp=4, n_sp=2, devices=jax.devices("cpu"))
    ref, _ = jpar.render_distributed(jscene, jcamera,
                                     _cfg(16, 4, mod=jinteg), mesh)
    ref_rgb = np.asarray(ref.rgb_sum)
    for r in _layout(world, 4, 2):
        np.testing.assert_allclose(r["film"].rgb_sum.numpy(), ref_rgb,
                                   rtol=0, atol=2e-3 * ref_rgb.max())
        np.testing.assert_allclose(r["film"].weight_sum.numpy(),
                                   np.asarray(ref.weight_sum), rtol=1e-5,
                                   atol=2e-6)
        assert r["film"].spp_done == int(ref.spp_done) == 4


def test_render_distributed_spans(world):
    """Each rank's (4, 2) render_distributed of 16x16 at spp 4 (2 steps):
    one ``crt.frame`` root and inside it one ``crt.pass.eager`` (gloo:
    every step eager, no capture, no release; the fine spans off without
    a profiler), and ``crt.collective.bytes`` = steps x (the rank's 64
    pixels over sp + the zero-padded 256 over dp) x 4 floats x 4 bytes."""
    for r in _layout(world, 4, 2):
        rec = r["frame_record"]
        root = rec["root"]
        assert rec["spans"] == [("crt.frame", root, None),
                                ("crt.pass.eager", root, root)]
        assert rec["counters"] == {"crt.collective.bytes":
                                   2 * 16 * (64 + 256)}


def test_render_distributed_releases_its_graph(world, one_rank,
                                               monkeypatch):
    """On a one-rank world with the step graph stood in for on the CPU
    (a graph that runs the captured step at each replay), the captured
    route gives the eager route's bits, captures into the card's kept
    pool, resets its graph under ``crt.pass.release`` before it returns
    and leaves no graph alive."""
    from test_torch_tracing import _Graph, _capture
    resets, made, pools = [], [], []
    pool = object()

    def capture(graph, fn, pool=None):
        pools.append(pool)
        return _capture(graph, fn)

    class Graph(_Graph):
        def reset(self):
            resets.append(metrics.RECORDER.stack[-1].name)
            super().reset()

    class Captured(graphs.CapturedGraph):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(weakref.ref(self))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "device_allocs", lambda device: (0, 0))
    monkeypatch.setattr(graphs, "kept_pool", lambda device: pool)
    monkeypatch.setattr(graphs, "CapturedGraph", Captured)
    scene, cfg = world[1]["sphere8"], _cfg(8, 4)
    want, _ = par.render_distributed(scene, _camera(8), cfg, one_rank)
    assert made == []
    monkeypatch.setattr(par, "captures", lambda mesh: True)
    first = metrics.RECORDER.last_id
    got, _ = par.render_distributed(scene, _camera(8), cfg, one_rank)
    gc.collect()
    assert resets == ["crt.pass.release"]
    assert pools == [pool]
    assert len(made) == 1 and made[0]() is None
    names = [s["name"] for s in metrics.spans() if s["id"] > first]
    assert names == ["crt.frame", "crt.pass.eager", "crt.pass.capture",
                     "crt.pass.release"]
    assert torch.equal(got.rgb_sum, want.rgb_sum)
    assert torch.equal(got.weight_sum, want.weight_sum)
    assert got.spp_done == want.spp_done == 4


def test_capture_into_a_pool_keeps_the_cache(monkeypatch):
    """``graphs.capture`` into a kept pool: the card synchronised, the
    capture into that pool on the pool's stream, the allocator's cache not
    emptied, ``capture_end`` reached when the captured function raises,
    and the launches it counted taken back either way."""
    calls = []

    class Graph:
        def capture_begin(self, pool=None):
            calls.append(("begin", pool))

        def capture_end(self):
            calls.append(("end",))

    @contextlib.contextmanager
    def stream(s):
        calls.append(("stream", s))
        yield

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: calls.append(("sync",)))
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append(("empty_cache",)))
    monkeypatch.setattr(torch.cuda, "stream", stream)
    pool = (("pool", 7), "holder", "side1")

    def captured():
        graphs.add_launch_counts({"interp": 3})
        calls.append(("fn",))
        return "out"
    before = graphs.launch_counts()
    out, launches = graphs.capture(Graph(), captured, pool=pool)
    assert (out, launches["interp"]) == ("out", 3)
    assert calls == [("sync",), ("stream", "side1"), ("begin", ("pool", 7)),
                     ("fn",), ("end",)]

    def fails():
        graphs.add_launch_counts({"interp": 2})
        raise RuntimeError("capture failed")
    calls.clear()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.capture(Graph(), fails, pool=pool)
    assert calls[1] == ("stream", "side1") and calls[-1] == ("end",)
    assert graphs.launch_counts() == before


def test_step_pool_is_kept_per_card(monkeypatch):
    """``graphs.kept_pool``: one pool handle and one side stream a card
    for the process, made once on that card, the pool held by a one-fill
    graph captured into it; a device without an index is the current
    card."""
    handles, holders, streams = iter(range(100)), [], []
    card = [None]

    class Graph:
        pass

    @contextlib.contextmanager
    def graph(g, pool=None):
        holders.append((g, pool))
        yield

    @contextlib.contextmanager
    def device(index):
        card[0] = index
        yield
        card[0] = None

    monkeypatch.setattr(graphs, "_KEPT_POOLS", {})
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("handle", next(handles)))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda: streams.append(card[0]) or len(streams))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: None)
    card0, card1 = (types.SimpleNamespace(index=0),
                    types.SimpleNamespace(index=1))
    first = graphs.kept_pool(card0)
    assert graphs.kept_pool(card0) == first
    second = graphs.kept_pool(card1)
    assert second[0] != first[0] and second[2] != first[2]
    assert graphs.kept_pool(types.SimpleNamespace(index=None)) == second
    assert [pool for _, pool in holders] == [first[0], second[0]]
    assert [g for g, _ in holders] == [first[1], second[1]]
    assert streams == [0, 1]


def test_sharded_train_step_runs_and_reduces(world):
    for r in _layout(world, 4, 2):
        t = r["train"]
        assert np.isfinite(t["losses"]).all()
        assert not torch.allclose(t["p1"], t["p0"])              # moved
        assert np.mean(t["losses"][-3:]) <= np.mean(t["losses"][:3])
    first = _layout(world, 4, 2)[0]["train"]
    for r in _layout(world, 4, 2)[1:]:
        assert r["train"]["losses"] == first["losses"]
        assert torch.equal(r["train"]["p1"], first["p1"])


@pytest.mark.parametrize("n_sp", sorted(GRAD_LAYOUTS))
def test_sharded_gradients_match_unsharded(world, n_sp):
    """The gradient averaged over the ranks equals the unsharded port's
    over samples 0..n_sp-1 and the JAX package's sharded train step's
    (optax.sgd(1.0): the update is the gradient) on the same layout."""
    import jax
    import optax
    from computational_ray_tracer_tpu.models import inverse as jinv
    from computational_ray_tracer_tpu.parallel import sharding as jpar
    from computational_ray_tracer_tpu.models import integrator as jinteg
    n_dp = GRAD_LAYOUTS[n_sp][0]
    tscene = world[1]["sphere8"]
    target = torch.full((8, 8, 3), 0.1)
    render_image, _ = tinv.make_render_fn(_camera(8), _cfg(8, 2), spp=n_sp)
    params = tinv.leaf_params(tinv.albedo_params(tscene)[0](tscene))
    loss = torch.mean((render_image(tinv.albedo_params(tscene)[1](
        tscene, params)) - target) ** 2)
    g_ref = torch.autograd.grad(loss, [params["albedo_coeffs"]])[0].numpy()
    loss = float(loss.detach())

    jscene, jcamera = world[0]["sphere8"]
    extract, insert = jinv.albedo_params(jscene)
    step, init, _ = jpar.make_train_step(
        jscene, jcamera, _cfg(8, 2, mod=jinteg),
        jpar.make_mesh(n_dp=n_dp, n_sp=n_sp, devices=jax.devices("cpu")),
        (extract, insert), optimizer=optax.sgd(1.0))
    jp = extract(jscene)
    jp_new, _, jloss = step(jp, init(jp), jscene, np.full((8, 8, 3), 0.1,
                                                          np.float32), 0)
    g_jax = np.asarray(jp["albedo_coeffs"]) - np.asarray(
        jp_new["albedo_coeffs"])
    for r in _layout(world, n_dp, n_sp):
        g = r["grad"]["grad"].numpy()
        np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-7)
        np.testing.assert_allclose(g, g_jax, rtol=1e-3, atol=1e-7)
        assert r["grad"]["loss"] == pytest.approx(loss, rel=1e-5)
        assert r["grad"]["loss"] == pytest.approx(float(jloss), rel=1e-3)


@pytest.mark.parametrize("n_dp,n_sp", ADAM_LAYOUTS)
def test_sharded_default_adam_matches_jax(world, n_dp, n_sp):
    """make_train_step's default optimizer, DeviceAdam at lr 2e-2, against
    the JAX make_train_step's, optax.adam(2e-2), over 3 steps of the
    direct 8x8 albedo loss on the same layout (gloo: every step eager):
    the losses within rtol 1e-3 (the reference tests'); the parameters
    after the first update within 5e-8 of max|p|, under half an ulp of the
    largest (DeviceAdam is exact at both layouts; torch.optim.Adam, the
    default before, is 1.4e-7 off at (1, 1)), and after the later two
    within 2e-6, where the gradients' own differences from the
    reference's take over (DeviceAdam: up to 8.7e-7 of max|p|)."""
    import jax
    from computational_ray_tracer_tpu.models import inverse as jinv
    from computational_ray_tracer_tpu.parallel import sharding as jpar
    from computational_ray_tracer_tpu.models import integrator as jinteg
    from jax.sharding import NamedSharding, PartitionSpec
    jscene, jcamera = world[0]["sphere8"]
    extract, insert = jinv.albedo_params(jscene)
    mesh = jpar.make_mesh(n_dp=n_dp, n_sp=n_sp, devices=jax.devices("cpu"))
    step, init, _ = jpar.make_train_step(
        jscene, jcamera, _cfg(8, 2, mod=jinteg), mesh, (extract, insert))
    # replicated over the mesh, as the step returns them: it compiles once
    jp, state = jax.device_put((extract(jscene), init(extract(jscene))),
                               NamedSharding(mesh, PartitionSpec()))
    losses, params = [], []
    for i in range(3):
        jp, state, loss = step(jp, state, jscene,
                               np.full((8, 8, 3), 0.1, np.float32), i * n_sp)
        losses.append(float(loss))
        params.append(np.asarray(jp["albedo_coeffs"]))
    for r in _layout(world, n_dp, n_sp):
        got = r["adam"]
        assert got["optimizer"] == "DeviceAdam"
        assert got["routes"] == ["eager"] * 3
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-3)
        for i, (p, ref) in enumerate(zip(got["params"], params)):
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(p.numpy(), ref, rtol=0,
                                       atol=(5e-8 if i == 0 else 2e-6)
                                       * scale, err_msg=f"step {i}")


@pytest.fixture
def one_rank():
    """A (1, 1) mesh over a world of one gloo rank in this process
    (make_mesh starts it), destroyed after the test."""
    try:
        yield par.make_mesh(1, 1, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_sharded_steps_read_nothing_back(world, one_rank):
    """At world size 1 on gloo, the sharded render step on a 0-d device
    index (the film of the int index, bit for bit) and the sharded train
    step with its default DeviceAdam on one make no host read and lift no
    host data: the condition of their capture on NCCL."""
    from test_torch_device_index import _HostReads
    scene = world[1]["sphere8"]
    render_step, _ = par.make_sharded_render(scene, _camera(8), _cfg(8, 2),
                                             one_rank)
    film = render_step(scene, tfilm.Film.create((8, 8)), 0)
    idx, target = torch.tensor(1), torch.full((8, 8, 3), 0.1)
    mode = _HostReads()
    with mode:
        got = render_step(scene, film, idx)
    assert mode.seen == [], mode.seen
    want = render_step(scene, film, 1)
    assert torch.equal(got.rgb_sum, want.rgb_sum)
    assert torch.equal(got.weight_sum, want.weight_sum)

    extract_insert = tinv.albedo_params(scene)
    step, init, _ = par.make_train_step(scene, _camera(8), _cfg(8, 2),
                                        one_rank, extract_insert)
    params = tinv.leaf_params(extract_insert[0](scene))
    opt = init(params)
    step(params, opt, scene, target, 0)
    mode = _HostReads()
    with mode:
        _, _, loss = step(params, opt, scene, target, idx)
    assert mode.seen == [], mode.seen
    assert isinstance(opt, tinv.DeviceAdam) and step.route == "eager"
    assert float(loss) > 0.0


def test_train_step_route():
    """make_train_step's route as a plain decision: eager on gloo or with
    an optimizer whose state is on the host (torch.optim.SGD,
    torch.optim.Adam without capturable); on NCCL with DeviceAdam or a
    capturable torch optimizer, a warm-up, a capture, then replays while
    the parameter names are equal and the leaves, the optimizer and the
    scene the same objects; any other of them warms up again (the next
    call captures anew)."""
    p, q = (torch.zeros(3, requires_grad=True) for _ in range(2))
    scene, adam = object(), tinv.DeviceAdam([p], lr=0.1)
    key = (("a",), (p,), adam, scene)
    for nccl, opt in ((False, adam), (True, torch.optim.Adam([p])),
                      (True, torch.optim.SGD([p], lr=0.0))):
        k = (("a",), (p,), opt, scene)
        assert par.step_route(nccl, k, None) == "eager"
        assert par.step_route(nccl, k, (k, "eager")) == "eager"
    capturable = torch.optim.Adam([p], capturable=True)
    for opt in (adam, capturable):
        k = (("a",), (p,), opt, scene)
        assert par.step_route(True, k, None) == "warm-up"
        assert par.step_route(True, k, (k, "warm-up")) == "capture"
        assert par.step_route(True, k, (k, "capture")) == "replay"
        assert par.step_route(True, k, (k, "replay")) == "replay"
    same = (("a",), (p,), adam, scene)         # equal, not the same tuple
    assert par.step_route(True, same, (key, "replay")) == "replay"
    for other in ((("b",), (p,), adam, scene), (("a",), (q,), adam, scene),
                  (("a",), (p, q), adam, scene),
                  (("a",), (p,), tinv.DeviceAdam([p], lr=0.1), scene),
                  (("a",), (p,), adam, object())):
        for last in ("warm-up", "capture", "replay"):
            assert par.step_route(True, other, (key, last)) == "warm-up"


@pytest.mark.cuda
def test_captured_sharded_steps_on_cuda():
    """Needs a CUDA card and nvcc: at world size 1 over NCCL,
    render_distributed (one eager step, then replays of its step graph)
    against the eager steps of make_sharded_render on the 32x32 Cornell
    box at spp 4, and make_train_step's step with its default DeviceAdam
    (warm-up, capture, replays) against its eager route over 6 steps of
    config 5 at 32x32: films, losses, parameters, gradients and launch
    counts equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: NCCL and a CUDA graph capture run only "
                    "on the card")
    from test_torch_train_graph import config5
    from computational_ray_tracer_tpu_torch import entry
    mesh = par.make_mesh(1, 1, device_type="cuda")
    try:
        scene, camera, cfg = entry.cornell_setup(res=32, spp=4,
                                                 device="cuda")
        render_step, _ = par.make_sharded_render(scene, camera, cfg, mesh)

        def eager_render():
            film = tfilm.Film.create(cfg.resolution, device="cuda")
            for base in range(cfg.sampler.spp):
                film = render_step(scene, film, base)
            return film
        films, counts = [], []
        for run in (eager_render,
                    lambda: par.render_distributed(scene, camera, cfg,
                                                   mesh)[0]):
            before = graphs.launch_counts()
            films.append(run())
            torch.cuda.synchronize()
            counts.append({k: n - before[k]
                           for k, n in graphs.launch_counts().items()})
        assert torch.equal(films[0].rgb_sum, films[1].rgb_sum)
        assert torch.equal(films[0].weight_sum, films[1].weight_sum)
        assert films[1].spp_done == 4 and counts[0] == counts[1]
        assert min(counts[0]["brute_closest"], counts[0]["interp"]) > 0

        start, camera, cfg, _, target = config5("cuda", res=32)
        ei = tinv.albedo_and_emission_params(start)
        runs = {}
        for name in ("captured", "eager"):
            step, init, _ = par.make_train_step(start, camera, cfg, mesh, ei)
            call = step if name == "captured" else (
                lambda *a: a[:2] + (step.eager(*a),))
            params = tinv.leaf_params(ei[0](start))
            opt = init(params)
            before = graphs.launch_counts()
            losses, routes = [], []
            for i in range(6):
                params, opt, loss = call(params, opt, start, target, i)
                losses.append(float(loss))
                routes.append(step.route)
            torch.cuda.synchronize()
            runs[name] = (params, losses, routes, {
                k: n - before[k] for k, n in graphs.launch_counts().items()})
        (p_c, l_c, r_c, n_c), (p_e, l_e, _, n_e) = (runs["captured"],
                                                    runs["eager"])
        assert r_c == ["warm-up", "capture"] + ["replay"] * 4
        assert l_c == l_e and l_c[-1] < l_c[0]
        for k in p_e:
            assert torch.equal(p_c[k], p_e[k]), k
            assert torch.equal(p_c[k].grad, p_e[k].grad), k
        assert n_c == n_e and n_c["interp_backward"] > 0, n_c
    finally:
        torch.distributed.destroy_process_group()


def test_global_mesh_and_init(world):
    """init_distributed: (8, 1) in the 8-rank world it started, a no-op
    (1, 1) in a single process; global_mesh(n_sp=2) spans every rank."""
    for r in world[3][8]:
        assert r["init"] == (8, 1)
        assert r["global_mesh"] == (4, 2)
    assert world[3][1][0]["init"] == (1, 1)


def test_sharded_packed_octree_matches_single_device(world):
    """The Cornell box in a packed octree (the octree wrappers' plain
    traversal on the CPU) renders the single-process film at (4, 2)."""
    _assert_film(_layout(world, 4, 2), "octree",
                 _render(world, "cornell16", _octree_cfg()), rtol=1e-4,
                 atol=1e-5)


def test_ranks_hold_identical_scenes(world):
    """Every rank rebuilt bit-identical scenes, packed octree included, and
    they equal the test process's."""
    digests = [r["digest"] for ranks in world[3].values() for r in ranks]
    own = {k: par.scene_digest(s) for k, s in world[1].items()}
    assert all(d == own for d in digests)
    assert world[1]["cornell16"].packed_octree is not None


def test_film_scatter_and_merge_match_jax():
    """Film.add_scattered (repeated pixel ids accumulate) and Film.merge
    against the JAX film's."""
    from computational_ray_tracer_tpu.ops import film as jfilm
    gen = np.random.default_rng(5)
    pix = gen.integers(0, 12 * 8, 300)
    rgb = gen.uniform(0, 2, (300, 3)).astype(np.float32)
    w = gen.uniform(0, 1, 300).astype(np.float32)
    jf = jfilm.Film.create((12, 8)).add_scattered(pix, rgb, w, 1)
    tf = tfilm.Film.create((12, 8)).add_scattered(
        torch.as_tensor(pix), torch.as_tensor(rgb), torch.as_tensor(w), 1)
    np.testing.assert_allclose(tf.rgb_sum.numpy(), np.asarray(jf.rgb_sum),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.weight_sum.numpy(),
                               np.asarray(jf.weight_sum), rtol=1e-6,
                               atol=1e-6)
    jm, tm = jf.merge(jf), tf.merge(tf)
    np.testing.assert_allclose(tm.rgb_sum.numpy(), np.asarray(jm.rgb_sum),
                               rtol=1e-6, atol=1e-6)
    assert tm.spp_done == int(jm.spp_done) == 2
