"""The port's public surface against the JAX package's, on the CPU.

Signature parity: for every module of ``computational_ray_tracer_tpu``,
each public function, class, class method, dataclass field and constant has
its name in the port's module of the same path; each function and method
accepts the reference's parameters by name, and its leading positional
parameters are the reference's in the same order (trailing extras such as
``device`` are allowed). Only the entries of ``ALLOWED`` differ, each with
its reason.

Values: the reference's own call forms (``sample_light`` and
``env_radiance`` with ``lam``, ``bsdf_eval``/``bsdf_sample`` positionally,
``Scene.build`` positionally, three-valued ``scene_intersect``,
``scene_occluded`` with ``n=None``), ``alive_fractions``, the ``li_*``
integrators, ``render()`` with ``compact``, uniform wavelengths with
bounds, ``PixelSensor.create`` in every colour space, ``MeshData.build``
with a tangent frame and a transform, on numpy inputs made from a seed,
through both packages."""

import ast
import dataclasses
import importlib
import inspect
import pkgutil
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import computational_ray_tracer_tpu as jpkg
from __graft_entry__ import _cornell_setup
from computational_ray_tracer_tpu.geometry2d import visibility as jvis
from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.models import lights as jlgt
from computational_ray_tracer_tpu.models import materials as jmat
from computational_ray_tracer_tpu.models import scene as jscene_mod
from computational_ray_tracer_tpu.ops import color as jcolor
from computational_ray_tracer_tpu.ops import numeric as jnum
from computational_ray_tracer_tpu.ops import sensor as jsen
from computational_ray_tracer_tpu.ops import shapes as jshp
from computational_ray_tracer_tpu.ops import spectrum as jspec
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.geometry2d import visibility as tvis
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.models import lights as tlgt
from computational_ray_tracer_tpu_torch.models import materials as tmat
from computational_ray_tracer_tpu_torch.models import scene as tscene_mod
from computational_ray_tracer_tpu_torch.ops import color as tcolor
from computational_ray_tracer_tpu_torch.ops import numeric as tnum
from computational_ray_tracer_tpu_torch.ops import sensor as tsen
from computational_ray_tracer_tpu_torch.ops import spectrum as tspec
from computational_ray_tracer_tpu_torch.ops import triangle as ttri
from test_torch_render import MATS, _material_inputs, export_scene

REF = "computational_ray_tracer_tpu"
PORT = "computational_ray_tracer_tpu_torch"
T = lambda a: torch.tensor(np.asarray(a))

# Every difference the parity check lets through, with its reason. Keys:
# a module (relative to the package), a name in a module, an attribute of
# any class ("*.name"), or a parameter ("module.function(param)": the
# reference's parameter -> the port's in its place).
ALLOWED = {
    "*.tree_flatten": "JAX pytree registration; torch tensors need none",
    "*.tree_unflatten": "JAX pytree registration; torch tensors need none",
    "ops.pallas_intersect": "replaced by ops/mesh_intersect_kernel.py over "
                            "csrc/mesh_intersect.cu",
    "ops.pallas_octree": "replaced by ops/octree_kernel.py over "
                         "csrc/octree_traverse.cu",
    "ops.pallas_interp": "replaced by ops/interp_kernel.py over "
                         "csrc/dense_interp.cu",
    "native": "replaced by csrc/host/, built by kernels/build.py",
    "models.scene.radix_order": "a TPU sort that only spares XLA compile "
                                "time; the port sorts with torch.argsort",
    "models.scene.INCOH_RAY_SUB": "packet shape of the Pallas octree kernel",
    "models.scene.INCOH_FRUSTUM": "packet shape of the Pallas octree kernel",
    "models.integrator.SPECTRAL_CACHE_MAX_COLS": "TPU compile-size cap; the "
                                                 "port always caches",
    "ops.sampling.rejection_sample_1d(key)": "generator",  # a PRNG key
    # becomes a torch.Generator
    "parallel.sharding.make_mesh(devices)": "device_type",  # torch.distributed
    # places one rank a device; the port names the device type
}
REPLACEMENTS = {"ops.pallas_intersect": "ops.mesh_intersect_kernel",
                "ops.pallas_octree": "ops.octree_kernel",
                "ops.pallas_interp": "ops.interp_kernel",
                "native": "kernels.build"}


def _ref_modules():
    """Every module of the reference (those under a replaced package, such
    as the native library's own module, go with it)."""
    paths = [m.name[len(REF) + 1:] for m in pkgutil.walk_packages(
        jpkg.__path__, REF + ".")]
    return [""] + sorted(p for p in paths if not any(
        p.startswith(r + ".") for r in REPLACEMENTS))


def _public(mod):
    """The public names a reference module binds at its top level: its own
    functions, classes and constants, the package's names it imports, and
    the package's modules it imports under their own names."""
    tree = ast.parse(inspect.getsource(mod))
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = True
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names[n.id] = True
        elif isinstance(node, ast.ImportFrom):
            ours = node.level > 0 or (node.module or "").startswith(REF)
            for a in node.names:
                value = getattr(mod, a.asname or a.name, None)
                renamed_module = (isinstance(value, types.ModuleType)
                                  and a.asname is not None)
                if ours and not renamed_module:
                    names[a.asname or a.name] = True
    return sorted(n for n in names if not n.startswith("_"))


def _positional(params):
    return [p.name for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _signature_faults(where, ref_fn, port_fn):
    try:
        ref = list(inspect.signature(ref_fn).parameters.values())
        port = list(inspect.signature(port_fn).parameters.values())
    except (TypeError, ValueError):
        return []
    renamed = {key.split("(")[1][:-1]: value for key, value in ALLOWED.items()
               if key.startswith(where + "(")}
    port_names = {p.name for p in port}
    port_kinds = {p.kind for p in port}
    faults = []
    for p in ref:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            if p.kind not in port_kinds:
                faults.append(f"{where}: no *{p.name}")
        elif renamed.get(p.name, p.name) not in port_names \
                and p.VAR_KEYWORD not in port_kinds:
            faults.append(f"{where}: no parameter {p.name!r}")
    want = [renamed.get(n, n) for n in _positional(ref)]
    got = _positional(port)[:len(want)]
    if got != want:
        faults.append(f"{where}: positional {got} != the reference's {want}")
    return faults


def _class_faults(where, ref_cls, port_cls):
    faults = []
    port_fields = ({f.name for f in dataclasses.fields(port_cls)}
                   if dataclasses.is_dataclass(port_cls) else set())
    if dataclasses.is_dataclass(ref_cls):
        for f in dataclasses.fields(ref_cls):
            if f.name.startswith("_"):
                continue
            if f.name not in port_fields and not hasattr(port_cls, f.name):
                faults.append(f"{where}: no field {f.name!r}")
    for name, raw in vars(ref_cls).items():
        if name.startswith("_") or f"*.{name}" in ALLOWED:
            continue
        if not isinstance(raw, (types.FunctionType, classmethod,
                                staticmethod, property)):
            continue
        if not hasattr(port_cls, name):
            faults.append(f"{where}: no attribute {name!r}")
        elif not isinstance(raw, property):
            faults += _signature_faults(f"{where}.{name}",
                                        getattr(ref_cls, name),
                                        getattr(port_cls, name))
    return faults


@pytest.mark.parametrize("path", _ref_modules())
def test_public_api_matches_reference(path):
    """The port's module of the same path has every public name of the
    reference's, with its parameters (see the module docstring)."""
    if path in ALLOWED:
        assert importlib.import_module(f"{PORT}.{REPLACEMENTS[path]}")
        return
    ref = importlib.import_module(f"{REF}.{path}" if path else REF)
    port = importlib.import_module(f"{PORT}.{path}" if path else PORT)
    faults = []
    for name in _public(ref):
        key = f"{path}.{name}"
        if key in ALLOWED:
            continue
        if not hasattr(port, name):
            faults.append(f"{key}: missing")
            continue
        r, p = getattr(ref, name), getattr(port, name)
        if inspect.isclass(r):
            faults += _class_faults(key, r, p)
        elif callable(r) and not isinstance(r, types.ModuleType):
            faults += _signature_faults(key, r, p)
    assert not faults, "\n".join(faults)


def test_allow_list_entries_are_still_needed():
    """Each allowed name is one the port lacks (or names differently)."""
    for key in ALLOWED:
        if key.startswith("*.") or key in REPLACEMENTS:
            continue
        if "(" in key:
            path, rest = key.split("(")[0].rsplit(".", 1)
            mod = importlib.import_module(f"{PORT}.{path}")
            params = inspect.signature(getattr(mod, rest)).parameters
            assert key.split("(")[1][:-1] not in params
            assert ALLOWED[key] in params
            continue
        path, name = key.rsplit(".", 1)
        assert not hasattr(importlib.import_module(f"{PORT}.{path}"), name)


# --- the reference's call forms, with its values ----------------------------

LIGHTS = [{"kind": "point", "position": (0.3, 1.5, -0.2), "scale": 5.0},
          {"kind": "distant", "direction": (-0.3, -1.0, 0.4),
           "rgb": (1.0, 0.9, 0.8)},
          {"kind": "quad", "corner": (-0.5, 0.99, -0.5), "edge1": (1.0, 0, 0),
           "edge2": (0, 0, 1.0), "spd_named": "stdillum-D65", "scale": 3.0},
          {"kind": "ambient", "scale": 0.5}]


def _light_tables():
    jt = jlgt.LightTable.build(LIGHTS)
    return jt, tlgt.LightTable.from_arrays(
        {k: np.asarray(getattr(jt, k)) for k in tlgt.FIELDS})


def test_sample_light_and_env_radiance_reference_call_form():
    """sample_light(table, p, n, lam, u_light, u_pos, world_radius) and
    env_radiance(table, lam): the SPDs interpolated at lam give the bits
    of the spectral cache's columns, and the reference's values."""
    jt, tt = _light_tables()
    nrm, _, _, lam, u2, u1, _, _ = _material_inputs(seed=11)
    p = np.random.default_rng(12).uniform(-0.9, 0.9, nrm.shape).astype(
        np.float32)
    ref, (ref_env, ref_n) = jax.jit(lambda *a: (
        jlgt.sample_light(jt, *a, 10.0), jlgt.env_radiance(jt, a[2])))(
            p, nrm, lam, u1, u2)
    got = tlgt.sample_light(tt, T(p), T(nrm), T(lam), T(u1), T(u2), 10.0)
    spd_vals = tspec.sample_dense_multi(tt.spd.T.contiguous(), T(lam))
    cached = tlgt.sample_light(tt, T(p), T(nrm), T(lam), T(u1), T(u2), 10.0,
                               spd_vals=spd_vals)
    for g, c, r in zip(got, cached, ref):
        assert torch.equal(g, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    env, n_amb = tlgt.env_radiance(tt, T(lam))
    assert torch.equal(env, tlgt.env_radiance(tt, T(lam), spd_vals)[0])
    assert int(n_amb) == int(ref_n) == 1
    np.testing.assert_allclose(env.numpy(), np.asarray(ref_env), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fn", ["eval", "sample"])
def test_bsdf_reference_call_forms(fn):
    """bsdf_eval(mat_row, n, wo, wi, lam, tex_rgb_coeffs) as the
    reference's integrator calls it, and bsdf_sample(mat_row, n, wo, u2, u1,
    lam, ...) as its physics tests do (eta and k from the view, no
    backface, then a positional wl_pdf and texture and a backface), at the
    tolerances of test_torch_render's BSDF test."""
    mats = [dict(MATS[0], use_texture=True)] + MATS[1:]
    jt = jmat.MaterialTable.build(mats)
    tt = tmat.MaterialTable.from_arrays(
        {k: np.asarray(getattr(jt, k)) for k in tmat.FIELDS})
    nrm, wo, wi, lam, u2, u1, mid, back = _material_inputs(seed=13)
    tex = np.random.default_rng(14).normal(size=(nrm.shape[0], 3)).astype(
        np.float32)
    jv = jmat.MaterialView.create(jt, jnp.asarray(mid))
    tv = tmat.MaterialView.create(tt, T(mid))
    if fn == "eval":
        calls = [(jmat.bsdf_eval(jv, nrm, wo, wi, lam, tex),
                  tmat.bsdf_eval(tv, T(nrm), T(wo), T(wi), T(lam), T(tex)))]
    else:
        pdf = np.ones_like(lam)
        calls = [(jmat.bsdf_sample(jv, nrm, wo, u2, u1, lam),
                  tmat.bsdf_sample(tv, T(nrm), T(wo), T(u2), T(u1), T(lam))),
                 (jmat.bsdf_sample(jv, nrm, wo, u2, u1, lam, pdf, tex,
                                   backface=back),
                  tmat.bsdf_sample(tv, T(nrm), T(wo), T(u2), T(u1), T(lam),
                                   T(pdf), T(tex), backface=T(back)))]
    for ref, got in calls:
        for g, r in zip(got, ref):
            r = np.asarray(r)
            if r.dtype == bool:
                np.testing.assert_array_equal(g.numpy(), r)
            else:
                np.testing.assert_allclose(g.numpy(), r, rtol=2e-5,
                                           atol=2e-5)
    emit = tmat.material_emission(tv, T(lam))
    assert torch.equal(emit, tmat.material_spectra(tv, T(lam))[0])
    np.testing.assert_allclose(emit.numpy(), np.asarray(
        jmat.material_emission(jv, lam)), rtol=1e-6, atol=1e-6)
    for k in ("emission", "eta", "k"):
        assert getattr(tv, k + "_table") is getattr(tt, k)


@pytest.fixture(scope="module")
def cornell16():
    """The Cornell headline scene at 16x16, spp 1: the reference's (its
    jnp brute force) and the port's with the same parameters."""
    jscene, jcamera, jcfg = _cornell_setup(res=16, spp=1)
    tscene = convert.scene_from_numpy(export_scene(jscene), device="cpu")
    _, tcamera, tcfg = entry.cornell_setup(res=16, spp=1, device="cpu")
    return jscene, jcamera, jcfg, tscene, tcamera, tcfg


def test_scene_reference_call_forms(cornell16):
    """Scene.build positionally (materials, lights, spheres, cylinders,
    disks, mesh, use_octree, texture_rgb, backface_cull_dir, use_pallas,
    octree_capacity), scene_intersect's three values, and scene_occluded
    with n=None (the offset along wi) and its default eps: the reference's
    bits."""
    pos, idx, uv, mats, _ = jmesh_gen.cornell_box(2.0)
    disks = [{"radius": 0.3, "material": 1,
              "transform": jshp.make_transform((0.2, -0.99, 0.1),
                                               rotate_deg=(90, 0, 0))}]
    args = lambda tri, m: ([{"kind": "diffuse"}, {"kind": "diffuse"}],
                           LIGHTS[2:3], None, None, disks, (tri, m), False,
                           None, None, True, None)
    js = jscene_mod.Scene.build(*args(jtri.MeshData.build(pos, idx, uvs=uv),
                                      jnp.asarray(mats)))
    ts = tscene_mod.Scene.build(*args(ttri.MeshData.build(pos, idx, uvs=uv),
                                      mats), device="cpu")
    assert ts.use_pallas and ts.packed_octree is None
    assert ts.wr == pytest.approx(js.wr, rel=1e-7)
    rng = np.random.default_rng(15)
    o = rng.uniform(-0.9, 0.9, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(500, np.inf, np.float32)
    dist = rng.uniform(0.1, 3.0, 500).astype(np.float32)
    eps = rng.uniform(1e-4, 1e-2, 500).astype(np.float32)
    (jsi, jmid, _), *occ = jax.jit(lambda *a: (
        jscene_mod.scene_intersect(js, *a[:3]),
        jscene_mod.scene_occluded(js, a[0], a[1], a[3], 1e-3),
        jscene_mod.scene_occluded(js, a[0], a[1], a[3], a[4]),
        jscene_mod.scene_occluded(js, a[0], a[1], a[3])))(
            o, d, t_max, dist, eps)
    tsi, tmid, tests = tscene_mod.scene_intersect(ts, T(o), T(d), T(t_max),
                                                  coherent=False)
    assert tests is None
    np.testing.assert_array_equal(tmid.numpy(), np.asarray(jmid))
    np.testing.assert_array_equal(tsi.valid.numpy(), np.asarray(jsi.valid))
    np.testing.assert_allclose(tsi.t.numpy(), np.asarray(jsi.t), rtol=1e-6,
                               atol=0)
    for e, ref in zip((1e-3, eps), occ):
        got = tscene_mod.scene_occluded(ts, T(o), T(d), T(dist), T(e))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = tscene_mod.scene_occluded(ts, T(o), T(d), T(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(occ[2]))
    assert 0.1 < got.float().mean() < 0.9


MODES = {"path": "mis", "simple": "simple", "walk": "walk"}


@pytest.mark.parametrize("integrator", sorted(MODES))
def test_alive_fractions_match_reference(cornell16, integrator, capsys):
    """alive_fractions at 16x16, spp 1, within 2 rays a depth of the
    reference's (the difference is printed)."""
    jscene, jcamera, jcfg, tscene, tcamera, tcfg = cornell16
    jcfg = dataclasses.replace(jcfg, integrator=integrator)
    tcfg = dataclasses.replace(tcfg, integrator=integrator)
    ref = np.asarray(jinteg.alive_fractions(jscene, jcamera, jcfg))
    got = tinteg.alive_fractions(tscene, tcamera, tcfg)
    assert got.shape == (tcfg.max_depth,) and float(got[0]) == 1.0
    rays = np.abs(got.numpy() - ref) * 16 * 16
    with capsys.disabled():
        print(f"alive_fractions {integrator}: rays apart a depth {rays}")
    assert rays.max() <= 2, (got, ref)
    assert got[-1] < 1.0


@pytest.mark.parametrize("integrator", sorted(MODES))
def test_li_integrators_match_path_scan_and_reference(cornell16,
                                                      integrator):
    """li_path, li_simple_path and li_random_walk: the bits of _path_scan
    in their mode, and the reference's within the render tests' 2e-3*max."""
    jscene, jcamera, jcfg, tscene, tcamera, tcfg = cornell16
    name = {"path": "li_path", "simple": "li_simple_path",
            "walk": "li_random_walk"}[integrator]
    pixel, wl, _, o, d = tinteg.camera_wavefront(
        tcamera, tcfg, tinteg.make_filter(tcfg), 0, "cpu")
    L, wl_out = getattr(tinteg, name)(tscene, o, d, wl, pixel, 0, tcfg)
    scan = tinteg._path_scan(tscene, o, d, wl, pixel, 0, tcfg,
                             MODES[integrator])
    assert torch.equal(L, scan[0]) and torch.equal(wl_out.pdf, scan[1].pdf)
    jwl = jspec.SampledWavelengths(jnp.asarray(wl.lam.numpy()),
                                   jnp.asarray(wl.pdf.numpy()))
    ref, _ = getattr(jinteg, name)(
        jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jwl,
        jnp.asarray(pixel.numpy().astype(np.uint32)), jnp.uint32(0), jcfg)
    ref = np.asarray(ref)
    np.testing.assert_allclose(L.numpy(), ref, rtol=0,
                               atol=2e-3 * max(float(ref.max()), 1e-3))


def test_render_compact_matches_full_wavefront(cornell16):
    """render() with cfg.compact runs render_pass_compact: the full
    wavefront's film at phase 8's rtol 1e-4 / atol 1e-5."""
    _, _, _, tscene, tcamera, tcfg = cornell16
    cfg = dataclasses.replace(tcfg, sampler=dataclasses.replace(
        tcfg.sampler, spp=2), compact=True, compact_quantum=64)
    full, _ = tinteg.render(tscene, tcamera,
                            dataclasses.replace(cfg, compact=False), chunk=2)
    calls = []
    compact = tinteg.render_pass_compact

    def counted(*args, **kw):
        calls.append(args[-1])
        return compact(*args, **kw)

    tinteg.render_pass_compact = counted
    try:
        film, _ = tinteg.render(tscene, tcamera, cfg, chunk=2)
    finally:
        tinteg.render_pass_compact = compact
    assert calls == [0, 1] and film.spp_done == 2
    torch.testing.assert_close(film.weight_sum, full.weight_sum, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(film.rgb_sum, full.rgb_sum, rtol=1e-4,
                               atol=1e-5)


def test_uniform_wavelengths_with_bounds():
    u = np.random.default_rng(16).uniform(0, 1, 500).astype(np.float32)
    for args in ((), (400.0, 700.0), (380.0, 780.0, 4)):
        ref = jspec.sample_uniform_wavelengths(jnp.asarray(u), *args)
        got = tspec.sample_uniform_wavelengths(T(u), *args)
        np.testing.assert_array_equal(got.lam.numpy(), np.asarray(ref.lam))
        np.testing.assert_array_equal(got.pdf.numpy(), np.asarray(ref.pdf))


@pytest.mark.parametrize("space", sorted(tcolor.COLOR_SPACES))
def test_sensor_in_each_colour_space(space):
    """PixelSensor.create(name, colorspace, sensor_illum, imaging_ratio):
    the matrix and sensor RGB at the sensor tests' tolerances, in each
    colour space, with imaging_ratio 2; the space keeps its primaries."""
    tcs, jcs = tcolor.COLOR_SPACES[space], jcolor.COLOR_SPACES[space]
    assert (tcs.r, tcs.g, tcs.b, tcs.w) == (jcs.r, jcs.g, jcs.b, jcs.w)
    illum = np.asarray(jspec.BlackbodySpectrum(4000.0)(
        jnp.arange(360.0, 831.0)), np.float32)
    rng = np.random.default_rng(17)
    L = rng.uniform(0, 3, (300, 8)).astype(np.float32)
    wl = jspec.sample_visible_wavelengths(
        jnp.asarray(rng.uniform(0, 1, 300).astype(np.float32)))
    twl = tspec.SampledWavelengths(T(wl.lam), T(wl.pdf))
    for name in (None, "canon_eos_5d"):
        ref = jsen.PixelSensor.create(name, jcs, illum, 2.0)
        got = tsen.PixelSensor.create(name, tcs, illum, 2.0)
        assert got.imaging_ratio == ref.imaging_ratio == 2.0
        np.testing.assert_allclose(got.xyz_from_sensor_rgb,
                                   ref.xyz_from_sensor_rgb, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(
            got.to_sensor_rgb(T(L), twl).numpy(),
            np.asarray(ref.to_sensor_rgb(jnp.asarray(L), wl)), rtol=1e-6,
            atol=1e-6)


def test_albedo_spectrum_in_dci_p3():
    rgb = np.array([[0.65, 0.05, 0.05], [0.12, 0.45, 0.15],
                    [0.5, 0.425, 0.3]], np.float32)
    lam = np.broadcast_to(np.arange(360, 831, 5, dtype=np.float32),
                          (3, 95)).copy()
    ref = jcolor.RGBAlbedoSpectrum.from_rgb(jnp.asarray(rgb), jcolor.DCI_P3)
    got = tcolor.RGBAlbedoSpectrum.from_rgb(rgb, colorspace=tcolor.DCI_P3)
    srgb = tcolor.RGBAlbedoSpectrum.from_rgb(rgb)
    np.testing.assert_allclose(got(T(lam)).numpy(),
                               np.asarray(ref(jnp.asarray(lam))), rtol=0,
                               atol=1e-4)
    assert (got(T(lam)) - srgb(T(lam))).abs().max() > 1e-2


def test_mesh_build_with_tangent_frame_and_transform():
    v, f, uv = jmesh_gen.displaced_icosphere(1)
    rng = np.random.default_rng(18)
    nrm, tan, bit = (rng.normal(size=v.shape).astype(np.float32)
                     for _ in range(3))
    xf = jshp.make_transform((0.5, -1.0, 2.0), rotate_deg=(10, 20, 30),
                             scale=1.5)
    for kw in ({"tangents": tan}, {"tangents": tan, "bitangents": bit},
               {"normals": nrm, "tangents": tan, "transform": xf}):
        ref = jtri.MeshData.build(v, f, uvs=uv, **kw)
        got = ttri.MeshData.build(v, f, None if "normals" not in kw
                                  else kw["normals"], uv,
                                  kw.get("tangents"), kw.get("bitangents"),
                                  kw.get("transform"))
        for k in ("positions", "normals", "uvs", "tangents", "bitangents",
                  "indices"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)))
    for name in ("difference_of_products", "fp_gamma", "make_transform",
                 "transform_point", "transform_vector", "transform_normal"):
        assert getattr(ttri, name).__module__.endswith("ops.shapes")


def test_compensated_sum_axis_and_is_visible_n_checks():
    vals = np.random.default_rng(19).normal(size=(64, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tnum.compensated_sum(T(vals), axis=0).numpy(),
        np.asarray(jnum.compensated_sum(jnp.asarray(vals), axis=0)))
    assert torch.equal(tnum.compensated_sum(T(vals), dim=0),
                       tnum.compensated_sum(T(vals), axis=0))
    square = [(0, 0), (4, 0), (4, 4), (2, 1), (0, 4)]
    tpoly, jpoly = tvis.Polygon(square), jvis.Polygon(square)
    for p, q in (((0.5, 0.5), (3.5, 0.5)), ((0.5, 3.5), (3.5, 3.5))):
        assert tvis.is_visible(tpoly, p, q, n_checks=8) \
            == bool(jvis.is_visible(jpoly, p, q, n_checks=8))
    assert not tvis.is_visible(tpoly, (0.5, 3.5), (3.5, 3.5), n_checks=8)
