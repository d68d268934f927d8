"""The port's one-program train step (models/inverse.py) on the CPU, at a
small BASELINE config 5: the Cornell box at 16x16, Sobol spp 2, path/MIS
depth 2, with every leaf of albedo_and_emission_params (the albedo
coefficients alone against the JAX package, as config5_inverse trains).

``inverse.optimize`` runs ``inverse.DeviceAdam`` (optax.adam's update in
float32 tensor ops, its step count on the device) on every device; on a
CUDA scene it runs step 0 eagerly and replays one captured CUDA graph
(a ``graphs.CapturedGraph``) for every later step. Here: a step of that form
reads nothing back to the host and lifts no host data (the condition of
the capture; ``torch.optim.Adam`` reads its step counts), ``optimize`` on
the CPU is the eager DeviceAdam loop bit for bit, ``torch.optim.Adam``
stays close to it, DeviceAdam follows optax's update, and the loss history
follows the JAX ``optimize`` (within 1e-6 on golden configuration 1,
where ``torch.optim.Adam`` is 3.1e-6 off). The capture itself runs on the
card only (the ``cuda``-marked test, and ``chip_smoke.py`` phase 24)."""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from test_torch_device_index import _HostReads
from test_torch_render import export_scene
from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.models import inverse as jinv
from computational_ray_tracer_tpu.models.scene import Scene as JScene
from computational_ray_tracer_tpu.ops import camera as jcam
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models import inverse as inv
from computational_ray_tracer_tpu_torch.ops import camera as cam

RES, SPP, DEPTH = 16, 2, 2


def view(res, spp, depth, package=(cam, integ)):
    """config 5's full-scale view (fov 70 from z = -2.2) at ``res``, Sobol
    ``spp``, path/MIS ``depth``: (camera, cfg) of ``package``."""
    camera_mod, integ_mod = package
    camera = camera_mod.PerspectiveCamera.create(
        (0, 0, -2.2), (res, res), fov_y=70.0, look_at=(0, 0, 0))
    cfg = integ_mod.RenderConfig(
        resolution=(res, res),
        sampler=integ_mod.SamplerConfig(kind="sobol", spp=spp),
        integrator="path", max_depth=depth)
    return camera, cfg


def config5(device="cpu", res=RES, spp=SPP, depth=DEPTH):
    """(start scene, camera, cfg, lr, target image) of config 5 at a small
    size: entry.config5_setup's scenes and lr, the target rendered by the
    port."""
    target, start, _, _, lr, _ = entry.config5_setup("full", device)
    camera, cfg = view(res, spp, depth)
    render_image, _ = inv.make_render_fn(camera, cfg)
    with torch.no_grad():
        target_img = render_image(target)
    return start, camera, cfg, lr, target_img


@pytest.fixture(scope="module")
def small():
    return config5()


def _step(small, adam):
    """(step, params) of a fresh start with the optimizer class ``adam``."""
    start, camera, cfg, lr, target_img = small
    ei = inv.albedo_and_emission_params(start)
    params = inv.leaf_params(ei[0](start))
    opt = adam(list(params.values()), lr=lr)
    return inv.make_step(camera, cfg, ei, target_img, params, start,
                         opt), params


def test_device_step_reads_nothing_back(small):
    """The second step of the card's form (zero_grad, the 2 passes, the
    MSE, backward, DeviceAdam) makes no host read and lifts no host data:
    what a CUDA graph capture needs. torch.optim.Adam's step reads its step
    counts back (``.item()``), which is why the card does not use it."""
    reads = {}
    for adam in (inv.DeviceAdam, torch.optim.Adam):
        step, _ = _step(small, adam)
        step()
        mode = _HostReads()
        with mode:
            loss = step()
        assert float(loss) > 0.0
        reads[adam] = mode.seen
    assert reads[inv.DeviceAdam] == [], reads[inv.DeviceAdam]
    assert "aten._local_scalar_dense.default" in reads[torch.optim.Adam]


def _eager_loop(start, camera, cfg, ei, target, steps, lr, adam):
    """The eager loop of optimize with the optimizer class ``adam``,
    written out: DeviceAdam's is the CPU's reference, bit for bit."""
    extract, insert = ei
    loss_fn = inv.make_loss_fn(camera, cfg, ei, target)
    params = inv.leaf_params(extract(start))
    opt = adam(list(params.values()), lr=lr)
    history = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(params, start)
        loss.backward()
        opt.step()
        history.append(float(loss.detach()))
    return {k: v.detach() for k, v in params.items()}, history


def test_device_form_against_eager_loop(small):
    """optimize on the CPU is the eager DeviceAdam loop, bit for bit, and
    its callback gets copies. torch.optim.Adam (which optimize ran on the
    CPU before) has the same first loss and gradients bit for bit (the
    same forward and backward); from the first update on its arithmetic
    is not optax's (float64 bias corrections on the host, its own order of
    operations): its losses stay within rtol 1e-4 and its parameters
    within 1e-5 of max|p| of optimize's over 4 steps."""
    start, camera, cfg, lr, target_img = small
    ei = inv.albedo_and_emission_params(start)
    seen = []
    _, got, history = inv.optimize(start, camera, cfg, ei, target_img,
                                   steps=4, lr=lr,
                                   callback=lambda *a: seen.append(a))
    want, want_history = _eager_loop(start, camera, cfg, ei, target_img, 4,
                                     lr, inv.DeviceAdam)
    assert history == want_history and history[-1] < history[0]
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the callback's parameters keep the values of their step
    assert [i for i, *_ in seen] == [0, 1, 2, 3]
    assert all(torch.equal(seen[-1][1][k], got[k]) for k in got)
    assert not torch.equal(seen[0][1]["albedo_coeffs"],
                           got["albedo_coeffs"])

    steps = {adam: _step(small, adam) for adam in (inv.DeviceAdam,
                                                   torch.optim.Adam)}
    losses = {adam: float(step()) for adam, (step, _) in steps.items()}
    assert losses[inv.DeviceAdam] == losses[torch.optim.Adam]
    for k, p in steps[inv.DeviceAdam][1].items():
        assert torch.equal(p.grad, steps[torch.optim.Adam][1][k].grad), k
    torch_params, torch_history = _eager_loop(
        start, camera, cfg, ei, target_img, 4, lr, torch.optim.Adam)
    assert torch_history[0] == history[0]
    np.testing.assert_allclose(torch_history, history, rtol=1e-4)
    for k, p in got.items():
        scale = float(p.abs().max())
        np.testing.assert_allclose(torch_params[k].numpy(), p.numpy(),
                                   rtol=0, atol=1e-5 * scale, err_msg=k)


def test_adam_matches_optax_on_golden_config1():
    """The Adam fault fixed: golden configuration 1 (the diffuse sphere
    under a point light, direct) at 8x8, stratified spp 1, every leaf of
    albedo_and_emission_params against a black target, lr 0.02, 2 steps,
    through the JAX optimize (optax.adam) and the port's CPU optimize: the
    second loss, the first after an update, within rtol 1e-6 (DeviceAdam
    is 2.8e-7 off; torch.optim.Adam, the CPU's optimizer before, 3.1e-6),
    the first equal."""
    from test_golden import golden1_sphere_direct
    jscene, _, _ = golden1_sphere_direct()
    views = [(mod_cam.PerspectiveCamera.create(
                  (0, 0, -4), (8, 8), fov_y=40.0, look_at=(0, 0, 0)),
              mod_integ.RenderConfig(
                  resolution=(8, 8), integrator="direct", max_depth=1,
                  sampler=mod_integ.SamplerConfig(kind="stratified", spp=1,
                                                  xs=1, ys=1)))
             for mod_cam, mod_integ in ((jcam, jinteg), (cam, integ))]
    target = np.zeros((8, 8, 3), np.float32)
    _, _, ref = jinv.optimize(jscene, *views[0],
                              jinv.albedo_and_emission_params(jscene),
                              jnp.asarray(target), steps=2, lr=0.02)
    tscene = convert.scene_from_numpy(export_scene(jscene), "cpu")
    _, _, got = inv.optimize(tscene, *views[1],
                             inv.albedo_and_emission_params(tscene),
                             torch.tensor(target), steps=2, lr=0.02)
    assert got[0] == pytest.approx(ref[0], rel=1e-7)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)


def test_device_adam_follows_optax():
    """DeviceAdam against optax.adam(0.1) (run eagerly, as jax.numpy
    evaluates it op by op) on seeded gradients spanning 1e-12 to 10, for 8
    steps. Every expression is optax's in its order; torch's CPU sqrt
    (SLEEF, within an ulp) is not always the correctly rounded one, so a
    parameter may move by an ulp a step: held within 1e-6 of max|p|."""
    rng = np.random.default_rng(15)
    shapes = {"albedo_coeffs": (4, 3), "light_scale": (1,),
              "emission": (4, 471)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.adam(0.1)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jparams)
    tparams = {k: torch.tensor(v) for k, v in p0.items()}
    adam = inv.DeviceAdam(list(tparams.values()), lr=0.1)
    for _ in range(8):
        g = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-12, 2, size=s))
             .astype(np.float32) for k, s in shapes.items()}
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        adam.step()
        for k, p in tparams.items():
            ref = np.asarray(jparams[k])
            np.testing.assert_allclose(p.numpy(), ref, rtol=0,
                                       atol=1e-6 * float(np.abs(ref).max()),
                                       err_msg=k)
    assert int(adam.count) == int(state[0].count) == 8


def _jax_config5(albedos, res, spp, depth):
    """benchmarks/run_configs.py config5_inverse's scene with ``albedos``
    and its full-scale view at ``res``, ``spp``, ``depth``: (scene, camera,
    cfg) of the JAX package."""
    pos, idx, uv, mats, (lc, le1, le2) = jmesh_gen.cornell_box(2.0)
    scene = JScene.build(
        materials=[{"kind": "diffuse", "albedo_rgb": a} for a in albedos]
        + [{"kind": "diffuse", "albedo_rgb": (0, 0, 0),
            "emission_rgb": (1.0, 0.85, 0.6), "emission_scale": 6.0}],
        lights=[{"kind": "quad", "corner": tuple(lc), "edge1": tuple(le1),
                 "edge2": tuple(le2), "rgb": (1.0, 0.85, 0.6),
                 "scale": 6.0}],
        mesh=(jtri.MeshData.build(pos, idx, uvs=uv), jnp.asarray(mats)),
        use_octree=False)
    return (scene,) + view(res, spp, depth, (jcam, jinteg))


def test_loss_history_matches_jax():
    """The first 3 losses of the eager loop (DeviceAdam, every step as the
    graph replays it) and of optimize on the CPU, the same, against the
    reference's optimize (optax.adam at config 5's lr 0.1 on the albedo
    coefficients, as config5_inverse runs it) from the same start scene
    and target, within tests/test_torch_inverse.py's rtol 1e-3."""
    jtarget, *_ = _jax_config5(entry.CONFIG5_TARGET, RES, SPP, DEPTH)
    jstart, jcamera, jcfg = _jax_config5(entry.CONFIG5_START, RES, SPP,
                                         DEPTH)
    tstart, ttarget = (convert.scene_from_numpy(export_scene(s), "cpu")
                       for s in (jstart, jtarget))
    camera, cfg = view(RES, SPP, DEPTH)
    render_image, _ = inv.make_render_fn(camera, cfg)
    with torch.no_grad():
        target = render_image(ttarget)
    _, _, ref = jinv.optimize(jstart, jcamera, jcfg,
                              jinv.albedo_params(jstart),
                              jnp.asarray(target.numpy()), steps=3, lr=0.1)
    ei = inv.albedo_params(tstart)
    _, _, dev = inv._optimize(tstart, camera, cfg, ei, target, 3, 0.1, None)
    _, _, cpu = inv.optimize(tstart, camera, cfg, ei, target, steps=3,
                             lr=0.1)
    assert dev[-1] < dev[0] and cpu == dev
    np.testing.assert_allclose(dev, ref, rtol=1e-3)
    np.testing.assert_allclose(cpu, ref, rtol=1e-3)


@pytest.mark.cuda
def test_captured_step_on_cuda():
    """Needs a CUDA card and nvcc: config 5 at 32x32 (spp 2, depth 2)
    through optimize, which captures step 1 and replays it for steps 1-5,
    against the eager loop with DeviceAdam: the losses, the parameters and
    every kernel's launch count equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a CUDA graph is captured only on the "
                    "card")
    start, camera, cfg, lr, target_img = config5("cuda", res=32)
    ei = inv.albedo_and_emission_params(start)
    runs = {}
    for name, run in (
            ("captured", lambda: inv.optimize(start, camera, cfg, ei,
                                              target_img, steps=6, lr=lr)),
            ("eager", lambda: inv._optimize(start, camera, cfg, ei,
                                            target_img, 6, lr, None))):
        before = graphs.launch_counts()
        _, params, history = run()
        torch.cuda.synchronize()
        runs[name] = (params, history, {
            k: n - before[k] for k, n in graphs.launch_counts().items()})
    (p_c, h_c, n_c), (p_e, h_e, n_e) = runs["captured"], runs["eager"]
    assert h_c == h_e and h_c[-1] < h_c[0]
    assert all(torch.equal(p_c[k], p_e[k]) for k in p_e)
    assert n_c == n_e and min(n_c["brute_closest"], n_c["interp"],
                              n_c["interp_backward"]) > 0, n_c

