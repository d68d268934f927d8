"""The textured mesh flagship (``entry.flagship_setup``) against the
benchmark's plain reference of it, on the CPU at small sizes: the port's
``render()`` and ``gpubench/reference/textured.py``'s film bit for bit
(on CPU tensors every kernel wrapper runs its plain version, and the
reference's any hit stops at the first hit where the port's CPU route
takes the closest hit's id: the same bit), the benchmark's mesh
generator, the ``mesh.flagship`` configuration against the entry, the
reference's any-hit traversal against its closest hit, and the octree's
spans and counters. The ``cuda`` test holds ``render()``'s kept pass of
the flagship to the eager loop on the card."""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.utils import mesh_gen, metrics
from gpubench import cells, harness, scenes
from gpubench.meshes import displaced_icosphere
from gpubench.reference import textured
from gpubench.traffic import textured_frames

RES = 16
SMALL = {"mesh": {"params": {"subdiv": 3}}, "accel": {"capacity": 16}}


def _config(**over):
    return harness.merge(cells.config("flagship_mesh327k"),
                         harness.merge(SMALL, over))


def _cell():
    return harness.merge(cells.cell("mesh.flagship"),
                         {"view": {"render": {"resolution": [RES, RES]}}})


@pytest.fixture(scope="module")
def arrays():
    return scenes.mesh_arrays(_config())


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_render_matches_the_plain_reference(arrays, seed):
    """A texture and an albedo drawn from the seed: the port's film sums
    and resolved image equal the reference's bit for bit."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0.0, 1.0, (32, 32, 3)).astype(np.float32)
    albedo = [tuple(rng.uniform(0.2, 0.9, 3))]
    config, cell = _config(), _cell()
    port = scenes.namespace(scenes.PORT)
    ref = scenes.namespace(scenes.REFERENCE)
    scene = textured_frames.port_scene(port, config, arrays, "cpu", tex,
                                       albedo)
    camera, cfg = scenes.view(port, config, cell, seed=seed)
    assert camera.lens_radius == 0.02 and cfg.sampler.xs == 2
    film, sensor = integ.render(scene, camera, cfg)
    image = film.resolve(sensor)

    ts = textured.attach(scenes.build_scene(ref, config, arrays, "cpu",
                                            albedo), tex, [0])
    r_camera, r_cfg = scenes.view(ref, config, cell, seed=seed)
    r_sensor = ref.integ.make_sensor(r_cfg)
    rgb, wt = textured.path_film(ts, r_camera, r_cfg, r_sensor, None, 4)
    r_image = ref.film.Film(rgb[:, None], wt[:, None]).resolve(r_sensor)
    assert torch.equal(film.rgb_sum.reshape(-1, 3), rgb)
    assert torch.equal(film.weight_sum.reshape(-1), wt)
    assert torch.equal(image.reshape(-1, 3), r_image[:, 0])
    assert float(rgb.abs().sum()) > 0.0


def test_benchmark_mesh_is_the_ports():
    ours = displaced_icosphere.generate(3)
    theirs = mesh_gen.displaced_icosphere(3)
    assert ours[3] is None
    for a, b in zip(ours[:3], theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert displaced_icosphere.generate(7)[1].shape == (20 * 4 ** 7, 3)


def test_config_is_the_entry_flagship(arrays):
    """The configuration's scene, camera and RenderConfig (through
    ``scenes.view``) are ``entry.flagship_setup``'s."""
    config = _config()
    port = scenes.namespace(scenes.PORT)
    scene = textured_frames.port_scene(port, config, arrays, "cpu")
    camera, cfg = scenes.view(port, config, cells.cell("mesh.flagship"))
    base = entry.mesh327k_setup(512, 4, subdiv=3, cap=16, device="cpu")[0]
    e_scene, e_camera, e_cfg = entry.flagship_setup(512, 4, scene=base,
                                                    device="cpu")
    assert camera == e_camera and cfg == e_cfg
    assert np.array_equal(textured_frames.texture_rgb(config),
                          mesh_gen.checker_texture(256))
    ours, theirs = integ.scene_leaves(scene), integ.scene_leaves(e_scene)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b


def test_plain_anyhit_is_the_closest_hits_verdict(arrays):
    """Seeded rays from inside and outside the mesh, some dead, some
    short: the any hit's verdict is the closest hit's t < t_max, and it
    tests and pops no more than the closest hit does."""
    ref = scenes.namespace(scenes.REFERENCE)
    packed = scenes.build_scene(ref, _config(), arrays, "cpu").packed_octree
    g = torch.Generator().manual_seed(5)
    n = 4099
    o = torch.rand((n, 3), generator=g) * 4.0 - 2.0
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=-1)
    t_max = torch.rand(n, generator=g) * 3.0
    t_max[::7] = -1.0
    t_max[1::5] = math.inf
    t, _, _, _, tests, pops = ref.octree.octree_traverse(
        o, d, t_max, packed.tree, packed.tri_verts, pops=True)
    hit, a_tests, a_pops = textured.octree_anyhit(o, d, t_max, packed.tree,
                                                  packed.tri_verts)
    assert torch.equal(hit, t < t_max)
    assert 0 < int(hit.sum()) < n
    assert bool((a_tests <= tests).all()) and bool((a_pops <= pops).all())
    assert bool((a_pops[t_max > 0] >= 1).all())


def test_octree_spans_and_counters(arrays, monkeypatch):
    """While a profiler records, each traversal is a crt.octree.<mode>
    span and counts its rays and live rays, as plain torch counts
    them; nothing is recorded without a profiler."""
    config = _config()
    port = scenes.namespace(scenes.PORT)
    scene = textured_frames.port_scene(port, config, arrays, "cpu")
    camera, cfg = scenes.view(port, config, _cell(), seed=9)
    handed = {"closest": [], "anyhit": []}
    closest, anyhit = okern.octree_intersect, okern.octree_anyhit

    def spy(mode, fn):
        def wrapped(o, d, t_max, *args, **kw):
            handed[mode].append(t_max.detach().clone())
            return fn(o, d, t_max, *args, **kw)
        return wrapped

    metrics.reset()
    integ.render(scene, camera, cfg, passes=1)
    assert not any(s["name"].startswith("crt.octree")
                   for s in metrics.spans())
    assert metrics.counters() == {}
    monkeypatch.setattr(okern, "octree_intersect", spy("closest", closest))
    monkeypatch.setattr(okern, "octree_anyhit", spy("anyhit", anyhit))
    with profile(activities=[ProfilerActivity.CPU]):
        integ.render(scene, camera, cfg, passes=1)
    names = [s["name"] for s in metrics.spans()]
    counts = metrics.counters()
    for mode in ("closest", "anyhit"):
        assert names.count(f"crt.octree.{mode}") == cfg.max_depth
        assert len(handed[mode]) == cfg.max_depth
        assert counts[f"crt.octree.lanes.{mode}"] == sum(
            t.numel() for t in handed[mode])
        assert counts[f"crt.octree.live.{mode}"] == sum(
            int((t > 0).sum()) for t in handed[mode])
    assert counts["crt.octree.lanes.closest"] == cfg.max_depth * RES * RES
    assert 0 < counts["crt.octree.live.anyhit"] < counts[
        "crt.octree.live.closest"]


@pytest.mark.cuda
def test_flagship_kept_pass_on_cuda():
    """The flagship through render() on the card: a first call captures,
    calls with new seeds replay the kept graph (its texture, octree and
    thin-lens tensors in the key), each film bit for bit the eager
    loop's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scene, camera, cfg = entry.flagship_setup(device="cuda")

    def routes(seed):
        cfg_s = dataclasses.replace(cfg, sampler=dataclasses.replace(
            cfg.sampler, seed=seed))
        metrics.reset()
        film, _ = integ.render(scene, camera, cfg_s)
        got = metrics.counters()
        flt, sensor = integ.make_filter(cfg_s), integ.make_sensor(cfg_s)
        eager = integ.accumulate(
            lambda i: integ.render_pass(scene, camera, cfg_s, flt, sensor,
                                        i),
            filmmod.Film.create(cfg_s.resolution, device="cuda"),
            cfg_s.sampler.spp)
        assert torch.equal(film.rgb_sum, eager.rgb_sum)
        assert torch.equal(film.weight_sum, eager.weight_sum)
        return got.get("crt.graph.kept", 0), got.get("crt.graph.captured", 0)

    assert routes(1) == (0, 1)
    assert routes(2**31 + 5) == (1, 0)
    assert routes(12345) == (1, 0)
