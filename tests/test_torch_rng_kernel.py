"""The sampler kernel (``csrc/sampler.cu``) and its wrapper
(``ops/rng_kernel.py``).

On the CPU: the wrapper on CPU tensors returns ``ops/rng.py``'s draws
exactly for every kind it takes; a CPU pass through ``SamplerConfig`` is
the pass of the plain samplers; the kernel's early-stopping cycle walk,
written out lane by lane, equals ``rng.permutation_element``'s fixed
count of masked steps for every index; the host parameters a launch takes;
importing the wrapper loads no library.

On the card (``cuda``-marked; skip without one): the kernel against the
plain version on CUDA tensors, bit for bit, for every kind, 1D and 2D, spp
in {1, 7, 32, 100, 128} (jitter on and off), dims {0, 1, 5, 37, 38, 71,
72, 141}, sample indices past spp, pixel ids in raster order, a gathered
subset and random values up to 2^32 - 1, a Python-int and a 0-d device
index; a 0-d device seed against the int seed, also in a captured
graph whose seed the host rewrites; a captured graph that steps the
index; one Cornell pass and one canonical pass whose films equal the
plain sampler's, with 20 and 3 launches."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from computational_ray_tracer_tpu_torch import entry
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.ops import rng
from computational_ray_tracer_tpu_torch.ops import rng_kernel as rk
from computational_ray_tracer_tpu_torch.ops import sensor as sen
from computational_ray_tracer_tpu_torch.utils import mesh_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2147600301
SPPS = (1, 7, 32, 100, 128)
DIMS = (0, 1, 5, 37, 38, 71, 72, 141)
# the 2D stratified grid of each spp
GRIDS = {1: (1, 1), 7: (7, 1), 32: (4, 8), 100: (10, 10), 128: (16, 8)}
CASES = [(kind, two_d) for kind in rk.KINDS for two_d in (False, True)]


def _samples(spp):
    """Indices below spp and past it (the plain version's result there)."""
    return (0, spp - 1, spp + 2, (1 << 32) + 3)


def _jitters(kind):
    return (True, False) if kind == "stratified" else (True,)


def _draw(fn, kind, two_d, pixel, sample, dim, spp, jitter):
    xs, ys = GRIDS.get(spp, (1, spp))
    if two_d:
        return fn[1](kind, SEED, pixel, sample, dim, spp, xs, ys, jitter)
    return fn[0](kind, SEED, pixel, sample, dim, spp, jitter)


KERNEL = (rk.draw_1d, rk.draw_2d)
PLAIN = (rk.plain_1d, rk.plain_2d)


def _rng_draw(kind, two_d, pixel, sample, dim, spp, jitter):
    """ops/rng.py called directly, as SamplerConfig called it before."""
    xs, ys = GRIDS[spp]
    if kind == "stratified":
        return (rng.stratified_2d(SEED, pixel, sample, dim, xs, ys, jitter)
                if two_d else
                rng.stratified_1d(SEED, pixel, sample, dim, spp, jitter))
    if kind == "sobol":
        return (rng.sobol_owen_2d if two_d else rng.sobol_owen_1d)(
            SEED, pixel, sample, dim, spp=spp)
    return (rng.independent_2d if two_d else rng.independent_1d)(
        SEED, pixel, sample, dim)


@pytest.mark.parametrize("kind,two_d", CASES)
def test_wrapper_on_cpu_is_rng(kind, two_d):
    """CPU tensors take ops/rng.py's route: the same bits and shape."""
    gen = np.random.default_rng(3)
    pixel = torch.as_tensor(np.concatenate([
        np.arange(64), gen.integers(0, 1 << 32, 64)]), dtype=torch.int64)
    launches = rk.LAUNCHES
    for spp in (7, 32, 100):
        for dim in (0, 72):
            for sample in (1, spp + 2):
                for jitter in _jitters(kind):
                    got = _draw(KERNEL, kind, two_d, pixel, sample, dim, spp,
                                jitter)
                    want = _rng_draw(kind, two_d, pixel, sample, dim, spp,
                                     jitter)
                    assert got.shape == want.shape == pixel.shape + (
                        (2,) if two_d else ())
                    assert torch.equal(got, want), (spp, dim, sample)
    assert rk.LAUNCHES == launches


def _old_get_1d(self, pixel, sample_idx, dim):
    if self.kind == "stratified":
        return rng.stratified_1d(self.seed, pixel, sample_idx, dim,
                                 self.spp, self.jitter)
    if self.kind == "sobol":
        return rng.sobol_owen_1d(self.seed, pixel, sample_idx, dim,
                                 spp=self.spp)
    return rng.independent_1d(self.seed, pixel, sample_idx, dim)


def _old_get_2d(self, pixel, sample_idx, dim):
    if self.kind == "stratified":
        return rng.stratified_2d(self.seed, pixel, sample_idx, dim,
                                 self.xs, self.ys, self.jitter)
    if self.kind == "sobol":
        return rng.sobol_owen_2d(self.seed, pixel, sample_idx, dim,
                                 spp=self.spp)
    return rng.independent_2d(self.seed, pixel, sample_idx, dim)


@pytest.mark.parametrize("sampler", [
    dict(kind="sobol", spp=6, seed=SEED),
    dict(kind="stratified", spp=6, xs=3, ys=2, seed=5),
    dict(kind="independent", spp=4, seed=9)])
def test_cpu_pass_unchanged(sampler, monkeypatch):
    """A CPU Cornell pass (16x16, path/MIS depth 4) through SamplerConfig
    equals the pass whose draws call ops/rng.py directly, bit for bit."""
    scene, camera, cfg = entry.cornell_setup(res=16, spp=4, device="cpu")
    cfg = dataclasses.replace(cfg, sampler=integ.SamplerConfig(**sampler))
    flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
    got = integ.render_pass(scene, camera, cfg, flt, sensor,
                            torch.tensor(3))
    monkeypatch.setattr(integ.SamplerConfig, "_get_1d", _old_get_1d)
    monkeypatch.setattr(integ.SamplerConfig, "_get_2d", _old_get_2d)
    want = integ.render_pass(scene, camera, cfg, flt, sensor, 3)
    assert float(want[0].max()) > 0.0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _lane_walk(i, n, p):
    """The kernel's permute() for one lane, in Python ints: the scramble
    of rng.permutation_element, then at most (w + 1) - n more, stopping at
    the first value below n."""
    w = n - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    k0, k1 = p & w, (p >> 16) & w

    def scramble(x):
        for c_mul, c_xor, s in ((0x9E3779B9, 0x85EBCA6B, 5),
                                (0xC2B2AE35, 0x27D4EB2F, 3),
                                (0x165667B1, 0x9E3779B9, 7)):
            x = (x * c_mul) & w
            x ^= x >> s
            x ^= k0
            x = (x * c_xor) & w
            x ^= k1
            x ^= x >> 2
        return x & w

    x = scramble(i & w)
    walk = w + 1 - n if n & (n - 1) else 0
    step = 0
    while step < walk and x >= n:
        x = scramble(x)
        step += 1
    return ((x + p) & rng.MASK) % n


@pytest.mark.parametrize("n", [1, 7, 100, 129, 1000])
def test_early_stopping_walk_is_masked_walk(n):
    """The kernel's walk, which stops at the first x < n, equals the plain
    version's fixed (w + 1) - n masked steps for indices below and past
    n and seeded keys."""
    keys = np.random.default_rng(n).integers(0, 1 << 32, 64)
    idx = sorted({0, n - 1, n, n + 1, 2 * n + 3, (1 << 32) - 1}
                 | set(range(0, n, max(n // 16, 1))))
    want = rng.permutation_element(
        torch.as_tensor(idx)[:, None], n, torch.as_tensor(keys)[None, :])
    got = [[_lane_walk(i, n, int(p)) for p in keys] for i in idx]
    assert want.tolist() == got


def test_draw_params():
    """What the host hands the kernel: the permutation's mask and walk,
    the float32 reciprocals, the seed's low word (the kernel hashes it) and
    the direction numbers of dim % 72 and (dim + 1) % 72 with the dims kept
    unwrapped."""
    p = rk.draw_params("stratified", SEED, 141, 100, 10, 10, True, True)
    assert (p.n, p.w, p.walk, p.xs) == (100, 127, 28, 10)
    assert p.scale0 == p.scale1 == float(np.float32(1) / np.float32(10))
    assert p.seed == SEED & rng.MASK
    p = rk.draw_params("stratified", SEED, 3, 100, 1, 1, False, False)
    assert (p.n, p.walk, p.jitter) == (100, 28, 0)
    assert p.scale0 == float(np.float32(1) / np.float32(100))
    p = rk.draw_params("sobol", -1, 71, 32, 1, 1, True, True)
    assert (p.seed, p.dim0, p.dim1, p.n, p.w, p.walk) == (
        rng.MASK, 71, 72, 32, 31, 0)
    assert list(p.sobol) == rng.SOBOL_MATRICES[[71, 0]].reshape(-1).tolist()
    assert rk.draw_params("independent", 0, 0, 0, 1, 1, True, False).n == 1
    with pytest.raises(ValueError):
        rk.draw_params("sobol", 0, 0, 0, 1, 1, True, False)


def test_import_loads_no_library():
    """Importing the wrapper and drawing on the CPU builds and loads
    nothing: the kernel library is imported only by a launch."""
    code = (
        "import sys, torch\n"
        "from computational_ray_tracer_tpu_torch.models import integrator\n"
        "from computational_ray_tracer_tpu_torch.ops import rng_kernel as rk\n"
        "rk.draw_2d('sobol', 1, torch.arange(8), 0, 1, 32, 1, 1)\n"
        "assert rk.LAUNCHES == 0\n"
        "assert 'computational_ray_tracer_tpu_torch.kernels.build' not in "
        "sys.modules\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        rk.draw_1d("sobol", 0, torch.empty(4, dtype=torch.int64,
                                           device="meta"), 0, 0, 32)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sampler kernel runs only on the "
                    "card")
    return torch.device("cuda", 0)


def _pixel_sets(dev):
    gen = np.random.default_rng(11)
    gathered = np.arange(0, 512 * 512, 7)
    gathered = gathered[gen.permutation(gathered.size)][:5000]
    rand = gen.integers(0, 1 << 32, 4096)
    rand[:2] = (0, (1 << 32) - 1)
    return {name: torch.as_tensor(a, dtype=torch.int64, device=dev)
            for name, a in (("raster", np.arange(4096)),
                            ("gathered", gathered), ("random", rand))}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,two_d", CASES)
def test_kernel_matches_plain_on_cuda(kind, two_d):
    """The kernel equals ops/rng.py on the same CUDA tensors bit for bit,
    on an int and a 0-d device index, one launch a draw."""
    dev = _card()
    pixels = _pixel_sets(dev)
    checked = 0
    for spp in SPPS:
        for dim in DIMS:
            for sample in _samples(spp):
                idx = torch.tensor(sample, dtype=torch.int64, device=dev)
                for name, pixel in pixels.items():
                    for jitter in _jitters(kind):
                        want = _draw(PLAIN, kind, two_d, pixel, sample, dim,
                                     spp, jitter)
                        n0 = rk.LAUNCHES
                        got = [_draw(KERNEL, kind, two_d, pixel, s, dim, spp,
                                     jitter) for s in (sample, idx)]
                        assert rk.LAUNCHES - n0 == 2
                        for g in got:
                            assert g.shape == want.shape
                            assert torch.equal(g, want), (
                                spp, dim, sample, name, jitter)
                        checked += 1
    assert checked >= len(SPPS) * len(DIMS) * 4 * 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", rk.KINDS)
def test_captured_draws_step_the_index(kind):
    """Draws captured in a CUDA graph with the index stepped on the device:
    each of 4 replays equals the eager draws at that index."""
    dev = _card()
    pixel = torch.arange(250_000, dtype=torch.int64, device=dev)
    idx = torch.zeros((), dtype=torch.int64, device=dev)
    draws = lambda s: (rk.draw_1d(kind, SEED, pixel, s, 5, 100),
                       rk.draw_2d(kind, SEED, pixel, s, 1, 100, 10, 10))
    draws(idx)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = draws(idx)
        idx.add_(1)
    idx.fill_(0)
    for s in range(4):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(out, draws(s)):
            assert torch.equal(got, want), s
    assert int(idx) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("kind,two_d", CASES)
def test_device_seed_matches_int_seed_on_cuda(kind, two_d):
    """A seed read from the device (seed_word(seed) in a 0-d int64 tensor)
    gives the by-value launch's bits for seeds 0, 1, 2^31 - 1, 2^32 + 5, a
    negative one and SEED, on an int and a device index; and draws captured
    in a CUDA graph read the seed the host writes between replays."""
    dev = _card()
    pixel = _pixel_sets(dev)["random"]
    seed_dev = torch.zeros((), dtype=torch.int64, device=dev)
    draw = lambda seed, s: (
        rk.draw_2d(kind, seed, pixel, s, 37, 100, 10, 10) if two_d
        else rk.draw_1d(kind, seed, pixel, s, 37, 100))
    seeds = (0, 1, (1 << 31) - 1, (1 << 32) + 5, -12345, SEED)
    for seed in seeds:
        seed_dev.fill_(rk.seed_word(seed))
        for s in (3, torch.tensor(3, dtype=torch.int64, device=dev)):
            assert torch.equal(draw(seed_dev, s), draw(seed, s)), seed
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = draw(seed_dev, 3)
    for seed in seeds:
        seed_dev.fill_(rk.seed_word(seed))
        graph.replay()
        assert torch.equal(out, draw(seed, 3)), seed


def _plain_pass(monkeypatch, fn):
    """fn() with SamplerConfig's draws on ops/rng.py (the plain version on
    the card)."""
    with monkeypatch.context() as m:
        m.setattr(rk, "draw_1d", rk.plain_1d)
        m.setattr(rk, "draw_2d", rk.plain_2d)
        return fn()


@pytest.mark.cuda
def test_cornell_and_canonical_passes_on_cuda(monkeypatch):
    """A Cornell pass (Sobol spp 32, path/MIS depth 4: 20 draws) and a
    canonical pass (stratified 10 x 10, direct: 3 draws) on the card equal
    the same passes through the plain samplers bit for bit."""
    dev = _card()
    scene, camera, cfg = entry.cornell_setup(res=64, spp=32, device=dev)
    flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
    run = lambda: integ.render_pass(scene, camera, cfg, flt, sensor,
                                    torch.tensor(5, device=dev))
    with torch.no_grad():
        n0 = rk.LAUNCHES
        got = run()
        assert rk.LAUNCHES - n0 == 20
        want = _plain_pass(monkeypatch, run)
    assert float(want[0].max()) > 0.0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    mesh = mesh_gen.dragon_stand_in(target_tris=2000)
    scene, camera, cfg = entry.canonical_setup(128, 100, mesh=mesh,
                                               device=dev)
    sensor = sen.PixelSensor.create()
    run = lambda: entry.canonical_pass(scene, camera, cfg, sensor, 37)
    with torch.no_grad():
        n0 = rk.LAUNCHES
        got = run()
        assert rk.LAUNCHES - n0 == 3
        want = _plain_pass(monkeypatch, run)
    assert float(want[1].max()) > 0.0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
