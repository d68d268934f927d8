"""The bounce step's shade kernel (``csrc/shade.cu``, ``csrc/shade.cuh``,
``ops/shade_kernel.py``) against its plain version, the torch route of
``models/integrator.py`` ``_bounce_step``.

On the CPU (tier 1): the lane code of ``csrc/shade.cuh`` built for the
host with g++ stands in for the launcher; ``_bounce_step_fused`` runs with
it and is held to the torch route within 1e-6 (PyTorch's CPU kernels round
a few operations otherwise than its CUDA kernels, which the lane code
follows) on every material kind, light kind and mode, textured or not,
below and above ``rr_start``, all-dead and all-alive wavefronts, with the
dispersion collapse; the route choice (the CPU and autograd take the torch
route) and the ``crt.shade.*`` counters.

On the card (``cuda``-marked; skip without one): the kernel against the
torch route on the card, bit for bit (a scene of four lights within 1e-6:
its einsum is a cuBLAS kernel), state entry by entry, and render()'s kept
films against the torch route's eager loop.
"""

import ctypes
import dataclasses
import subprocess
import shutil

import pytest
import torch
from torch.profiler import profile, ProfilerActivity

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops import shade_kernel as sk
from computational_ray_tracer_tpu_torch.kernels import build
from computational_ray_tracer_tpu_torch.utils import metrics

LIGHTS = {"quad": ("quad",), "point_ambient": ("point", "ambient"),
          "distant_quad": ("distant", "quad"),
          "all": ("quad", "point", "distant", "ambient")}
MODES = {"mis": "path", "simple": "simple", "walk": "walk"}
KEYS = ("o", "d", "beta", "L", "alive", "specular", "pdf_prev", "n_prev",
        "lam_pdf")


def _setup(lights, texture, mode, res, device="cpu", depth=5):
    """``entry.material_kinds_setup``: the box with a sphere of each
    material kind, roulette from depth 2."""
    return entry.material_kinds_setup(res, LIGHTS[lights], texture,
                                      MODES[mode], depth, device=device)


def _camera_state(scene, camera, cfg, sample_idx=1):
    flt = integ.make_filter(cfg)
    pixel, wl, _, o, d = integ.camera_wavefront(camera, cfg, flt, sample_idx,
                                                scene.device)
    return pixel, integ._init_path_state(scene, o, d, wl)


@pytest.fixture(scope="module")
def host_lanes(tmp_path_factory):
    """``csrc/shade.cuh`` built for the host: (shade, resolve) stand-ins
    of :func:`sk.shade_bounce` and :func:`sk.resolve` on CPU tensors."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the lane code for the host")
    out = tmp_path_factory.mktemp("shade_host")
    shim = out / "shim.cpp"
    shim.write_text(
        '#include "shade.cuh"\n'
        'extern "C" void shade(const CrtShadeArgs* a) {\n'
        '  for (int64_t i = 0; i < a->n_lanes; ++i)\n'
        '    crt_shade::shade_lane(*a, i);\n}\n'
        'extern "C" void resolve(float* L, const float* nee,\n'
        '                        const uint8_t* occ, int n) {\n'
        '  for (int64_t j = 0; j < int64_t(n) * crt_shade::kS; ++j)\n'
        '    crt_shade::resolve_element(L, nee, occ, j);\n}\n')
    lib_path = out / "libshade_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-I", build.SRC_DIR, str(shim), "-o",
                    str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.shade.argtypes = [ctypes.c_void_p]
    lib.resolve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    calls = []

    def shade(scene, state, *args):
        state = {k: v.as_subclass(torch.Tensor) for k, v in state.items()}
        a, outputs, _ = sk.prepare(scene, state, *args)
        lib.shade(ctypes.byref(a))
        calls.append("shade")
        return outputs

    def resolve(L, nee, occ):
        occ = occ.contiguous()
        lib.resolve(L.data_ptr(), nee.data_ptr(), occ.data_ptr(),
                    L.numel() // sk.S)
        calls.append("resolve")
        return L

    return shade, resolve, calls


@pytest.fixture
def stand_in(monkeypatch, host_lanes):
    shade, resolve, calls = host_lanes
    monkeypatch.setattr(sk, "shade_bounce", shade)
    monkeypatch.setattr(sk, "resolve", resolve)
    calls.clear()
    return calls


def _close(ref, got, rtol=1e-6):
    for key in KEYS:
        r, g = ref[key], got[key]
        assert r.shape == g.shape and r.dtype == g.dtype, key
        if r.dtype == torch.bool:
            assert torch.equal(r, g), key
        else:
            gap = float((r - g).abs().sum() / r.abs().sum().clamp(min=1e-30))
            assert gap <= rtol, (key, gap)


def _walk(scene, cfg, mode, pixel, state, check):
    """Bounce ``state`` to cfg.max_depth by the torch route, holding
    ``_bounce_step_fused`` to it at each depth (``check``)."""
    for depth in range(cfg.max_depth):
        ref = integ._bounce_step_torch(scene, cfg, state, depth, pixel, 1,
                                       mode)
        got = integ._bounce_step_fused(scene, cfg, state, depth, pixel, 1,
                                       mode)
        check(ref, got)
        state = ref
    return state


@pytest.mark.parametrize("texture", [True, False], ids=["tex", "notex"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("lights", list(LIGHTS))
def test_host_lanes_match_torch_route(stand_in, lights, mode, texture):
    scene, camera, cfg = _setup(lights, texture, mode, 16)
    pixel, state = _camera_state(scene, camera, cfg)
    end = _walk(scene, cfg, mode, pixel, state, _close)
    assert stand_in.count("shade") == cfg.max_depth
    assert stand_in.count("resolve") == (0 if mode == "walk"
                                         else cfg.max_depth)
    assert 0 < int(end["alive"].sum()) < end["alive"].numel() // 4


def test_host_lanes_collapse_dispersion(stand_in):
    """Rays through the BK7 sphere collapse to the hero wavelength."""
    scene, camera, cfg = _setup("quad", False, "mis", 24)
    pixel, state = _camera_state(scene, camera, cfg)
    end = _walk(scene, cfg, "mis", pixel, state, _close)
    collapsed = (end["lam_pdf"][:, 1:] == 0).all(-1)
    assert 0 < int(collapsed.sum()) < collapsed.numel()


def _wavefront(alive, device="cpu"):
    """A camera wavefront to bounce at depth 3 (past rr_start), every lane
    dead or every lane alive."""
    scene, camera, cfg = _setup("point_ambient", True, "mis", 12, device)
    pixel, state = _camera_state(scene, camera, cfg)
    if alive == "dead":
        state["alive"] = torch.zeros_like(state["alive"])
    assert bool(state["alive"].all()) == (alive == "alive")
    return scene, cfg, pixel, state


@pytest.mark.parametrize("alive", ["dead", "alive"])
def test_host_lanes_all_dead_and_all_alive(stand_in, alive):
    """An all-dead wavefront passes through; an all-alive one shades every
    lane that hits."""
    scene, cfg, pixel, state = _wavefront(alive)
    ref = integ._bounce_step_torch(scene, cfg, state, 3, pixel, 1, "mis")
    got = integ._bounce_step_fused(scene, cfg, state, 3, pixel, 1, "mis")
    _close(ref, got)
    if alive == "dead":
        assert not got["alive"].any() and torch.equal(got["o"], state["o"])
        assert torch.equal(got["L"], state["L"])
    else:
        assert int(got["alive"].sum()) > got["alive"].numel() // 2


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the route of a bounce on
    the card, without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _on_fake_card(state):
    state = dict(state)
    state["lam"] = torch.Tensor._make_subclass(_FakeCuda, state["lam"])
    return state


def test_route_choice(stand_in):
    """The CPU takes the torch route; on the card autograd through the step
    takes it too (grad enabled and a scene leaf that needs it), and
    everything else the kernel, seen through the stand-in launcher."""
    scene, camera, cfg = _setup("quad", True, "mis", 8)
    pixel, state = _camera_state(scene, camera, cfg)
    assert not integ._shades_on_card(scene, state)
    card = _on_fake_card(state)
    assert integ._shades_on_card(scene, card)
    leaf = scene.materials.albedo_coeffs.requires_grad_(True)
    assert not integ._shades_on_card(scene, card)
    with torch.no_grad():
        assert integ._shades_on_card(scene, card)
        got = integ._bounce_step(scene, cfg, card, 0, pixel, 1)
    assert stand_in == ["shade", "resolve"]
    leaf.requires_grad_(False)
    with torch.no_grad():
        _close(integ._bounce_step(scene, cfg, state, 0, pixel, 1), got)
    assert stand_in == ["shade", "resolve"]


@pytest.mark.parametrize("route", ["torch", "fused"])
def test_shade_counters(stand_in, route):
    """While a profiler records, every bounce counts its route once under
    ``crt.shade.fused`` or ``crt.shade.torch``; nothing is counted
    otherwise."""
    scene, camera, cfg = _setup("quad", False, "mis", 8, depth=3)
    pixel, state = _camera_state(scene, camera, cfg)
    if route == "fused":
        state = _on_fake_card(state)

    def scan():
        s = state
        with torch.no_grad():
            for depth in range(cfg.max_depth):
                s = integ._bounce_step(scene, cfg, s, depth, pixel, 1)

    metrics.reset()
    scan()
    assert metrics.counters() == {}
    stand_in.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        scan()
    other = "torch" if route == "fused" else "fused"
    assert metrics.counters() == {f"crt.shade.{route}": cfg.max_depth}
    assert f"crt.shade.{other}" not in metrics.counters()
    assert len(stand_in) == (2 * cfg.max_depth if route == "fused" else 0)


def test_wrapper_takes_cuda_tensors_only():
    scene, camera, cfg = _setup("quad", False, "mis", 4)
    pixel, state = _camera_state(scene, camera, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        sk.shade_bounce(scene, state, None, None, {}, "mis", False, 3e-5)
    with pytest.raises(ValueError, match="CUDA device"):
        sk.resolve(state["L"], state["L"], state["alive"])
    bad = dict(state, lam=state["lam"][..., :4])
    with pytest.raises(ValueError, match="wavelengths"):
        sk.prepare(scene, bad, None, None, {}, "mis", False, 3e-5)
    with pytest.raises(ValueError, match="mode"):
        sk.prepare(scene, state, None, None, {}, "bdpt", False, 3e-5)


# ---------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return "cuda"


def _bits(x):
    return x.view(torch.uint8) if x.dtype == torch.bool else x.view(
        torch.int32)


def _same_bits(ref, got, exact=True):
    for key in KEYS:
        r, g = ref[key], got[key]
        if exact or r.dtype == torch.bool:
            assert torch.equal(_bits(r), _bits(g)), key
        else:
            gap = float((r - g).abs().sum() / r.abs().sum().clamp(min=1e-30))
            assert gap <= 1e-6, (key, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("texture", [True, False], ids=["tex", "notex"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("lights", list(LIGHTS))
def test_kernel_matches_torch_route_on_cuda(lights, mode, texture):
    """Every bounce of a 64x64 wavefront, depth 0 to 5 with roulette from
    2: the kernel route's state bit for bit the torch route's on the card
    (four lights: within 1e-6, the einsum's cuBLAS order)."""
    scene, camera, cfg = _setup(lights, texture, mode, 64, _card(), depth=6)
    pixel, state = _camera_state(scene, camera, cfg)
    exact = lights != "all"
    with torch.no_grad():
        for depth in range(cfg.max_depth):
            ref = integ._bounce_step_torch(scene, cfg, state, depth, pixel,
                                           1, mode)
            before = sk.LAUNCHES
            got = integ._bounce_step(scene, cfg, state, depth, pixel, 1, mode)
            assert sk.LAUNCHES == before + 1
            _same_bits(ref, got, exact)
            state = ref
    assert 0 < int(state["alive"].sum()) < state["alive"].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("alive", ["dead", "alive"])
def test_all_dead_and_all_alive_on_cuda(alive):
    scene, cfg, pixel, state = _wavefront(alive, _card())
    with torch.no_grad():
        ref = integ._bounce_step_torch(scene, cfg, state, 3, pixel, 1, "mis")
        got = integ._bounce_step(scene, cfg, state, 3, pixel, 1, "mis")
    _same_bits(ref, got)


def _eager_torch_route(monkeypatch, scene, camera, cfg):
    flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
    monkeypatch.setattr(integ, "_shades_on_card", lambda *a: False)
    with torch.no_grad():
        film = integ.accumulate(
            lambda i: integ.render_pass(scene, camera, cfg, flt, sensor, i),
            filmmod.Film.create(cfg.resolution, device=scene.device),
            cfg.sampler.spp)
    monkeypatch.undo()
    return film


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cornell", "flagship", "kinds"])
def test_render_films_match_torch_route_on_cuda(monkeypatch, which):
    """render() through the kernel (the kept graph) against the torch
    route's eager loop: the films bit for bit, on the Cornell headline,
    the textured flagship at subdiv 3 and the box of every material
    kind."""
    dev = _card()
    if which == "cornell":
        scene, camera, cfg = entry.cornell_setup(res=64, spp=4, device=dev)
    elif which == "flagship":
        base, _, _ = entry.mesh327k_setup(res=64, spp=4, subdiv=3, cap=16,
                                          device=dev)
        scene, camera, cfg = entry.flagship_setup(res=64, scene=base,
                                                  device=dev)
    else:
        scene, camera, cfg = _setup("distant_quad", True, "mis", 64, dev)
    cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler, seed=(1 << 31) + 77))
    want = _eager_torch_route(monkeypatch, scene, camera, cfg)
    before = sk.LAUNCHES
    film, _ = integ.render(scene, camera, cfg)
    assert sk.LAUNCHES - before == cfg.sampler.spp * cfg.max_depth
    assert torch.equal(_bits(film.rgb_sum), _bits(want.rgb_sum))
    assert torch.equal(_bits(film.weight_sum), _bits(want.weight_sum))
    if integ._KEPT is not None:
        integ._forget(integ._KEPT)


@pytest.mark.cuda
def test_inverse_job_keeps_the_torch_route_on_cuda():
    """Config 5's eager training steps on the card (autograd through the
    bounces) take the torch route: every bounce counts ``crt.shade.torch``
    under a profiler, none ``crt.shade.fused``, and nothing launches the
    shade kernel; the target rendered under no_grad takes the kernel."""
    from computational_ray_tracer_tpu_torch.models import inverse as inv
    target, start, camera, cfg, lr, _ = entry.config5_setup("small", _card())
    render_image, _ = inv.make_render_fn(camera, cfg)
    before = sk.LAUNCHES
    with torch.no_grad():
        target_img = render_image(target)
    assert sk.LAUNCHES - before == cfg.sampler.spp * cfg.max_depth
    before = sk.LAUNCHES
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        inv._optimize(start, camera, cfg, inv.albedo_params(start),
                      target_img, 2, lr, None)
    counts = metrics.counters()
    assert sk.LAUNCHES == before
    assert counts.get("crt.shade.torch") == 2 * cfg.sampler.spp * \
        cfg.max_depth
    assert "crt.shade.fused" not in counts
