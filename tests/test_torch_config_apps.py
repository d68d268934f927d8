"""The port's checkpoints, metrics, scene config, ``scene_intersect``'s
triangle-test counter, the ``raytracer`` and ``shape_test`` apps and the
app dispatcher, against the JAX package on the same inputs: checkpoint
files interchangeable, resume bitwise, renders within 2e-3*max, hit
fractions and brute-force counts exact."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computational_ray_tracer_tpu.apps import raytracer as jrt
from computational_ray_tracer_tpu.apps import shape_test as jst
from computational_ray_tracer_tpu.models import integrator as jinteg
from computational_ray_tracer_tpu.models import scene as jscene_mod
from computational_ray_tracer_tpu.ops import film as jfilm
from computational_ray_tracer_tpu.utils import checkpoint as jck
from computational_ray_tracer_tpu.utils import config as jcfg
from computational_ray_tracer_tpu.utils import image as jimage
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu.utils import obj_loader as jobj
from computational_ray_tracer_tpu_torch import convert
from computational_ray_tracer_tpu_torch.apps import __main__ as tdispatch
from computational_ray_tracer_tpu_torch.apps import APP_NAMES
from computational_ray_tracer_tpu_torch.apps import raytracer as trt
from computational_ray_tracer_tpu_torch.apps import shape_test as tst
from computational_ray_tracer_tpu_torch.models import integrator as tinteg
from computational_ray_tracer_tpu_torch.models import scene as tscene_mod
from computational_ray_tracer_tpu_torch.ops import film as tfilm
from computational_ray_tracer_tpu_torch.ops import octree as toct
from computational_ray_tracer_tpu_torch.utils import checkpoint as tck
from computational_ray_tracer_tpu_torch.utils import config as tcfg
from computational_ray_tracer_tpu_torch.utils import image as timage
from computational_ray_tracer_tpu_torch.utils import metrics as tmetrics

T = torch.as_tensor

# tests/test_configs_aux.py's test_scene_config_file spec.
CONFIG_FILE_SPEC = {
    "render": {"resolution": [16, 16], "integrator": "direct",
               "sampler": {"kind": "stratified", "spp": 4, "xs": 2,
                           "ys": 2}, "filter": "box"},
    "camera": {"kind": "perspective", "position": [0, 0, -4],
               "look_at": [0, 0, 0], "fov_y": 45.0},
    "materials": [{"kind": "diffuse", "albedo_rgb": [0.6, 0.6, 0.2]}],
    "lights": [{"kind": "point", "position": [1, 2, -3],
                "spd_named": "stdillum-D65", "scale": 10.0}],
    "shapes": [{"kind": "sphere", "radius": 1.0, "material": 0},
               {"kind": "disk", "radius": 2.0, "material": 0,
                "transform": {"translate": [0, -1, 0],
                              "rotate_deg": [-90, 0, 0]}}],
}


def _obj_spec(path):
    """A displaced-icosphere OBJ in an octree (the default), direct."""
    return {
        "render": {"resolution": [16, 16], "integrator": "direct",
                   "sampler": {"kind": "sobol", "spp": 2}},
        "camera": {"position": [0, 0.5, -3.4], "look_at": [0, 0, 0],
                   "fov_y": 40.0},
        "materials": [{"kind": "diffuse", "albedo_rgb": [0.75, 0.71, 0.62]}],
        "lights": [{"kind": "distant", "direction": [-0.4, -1.0, 0.5],
                    "rgb": [1.0, 1.0, 1.0], "scale": 4.0}],
        "shapes": [{"kind": "mesh_obj", "path": str(path), "material": 0}],
    }


def _write_json(tmp_path, spec):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(spec))
    return str(p)


def _resolved(film, sensor):
    return np.asarray(film.resolve(sensor, to_srgb=False, clip=False))


def _close_to_golden(got, want):
    atol = 2e-3 * max(float(want.max()), 1e-3)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= atol


# --- checkpoints -------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_film_files_are_interchangeable(tmp_path, writer):
    """A film either package saves, the other loads: the same keys, arrays,
    spp_done and meta."""
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0, 2, (6, 8, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1, (6, 8)).astype(np.float32)
    p = str(tmp_path / "film.npz")
    meta = {"spp": 5, "scene": "x"}
    if writer == "port":
        tck.save_film(p, tfilm.Film(T(rgb), T(w), 5), meta)
        film, got_meta = jck.load_film(p)
        spp = int(film.spp_done)
    else:
        jck.save_film(p, jfilm.Film(jnp.asarray(rgb), jnp.asarray(w),
                                    jnp.int32(5)), meta)
        film, got_meta = tck.load_film(p, device="cpu")
        spp = film.spp_done
        assert isinstance(spp, int) and film.rgb_sum.device.type == "cpu"
    np.testing.assert_array_equal(np.asarray(film.rgb_sum), rgb)
    np.testing.assert_array_equal(np.asarray(film.weight_sum), w)
    assert spp == 5 and got_meta == meta
    with np.load(p) as z:
        assert sorted(z.files) == ["meta", "rgb_sum", "spp_done",
                                   "weight_sum"]
        assert z["spp_done"].dtype == np.int32


def _resume_scene(case):
    if case == "sphere_direct":      # tests/test_configs_aux.py's resume
        from computational_ray_tracer_tpu_torch.models.scene import Scene
        from computational_ray_tracer_tpu_torch.ops import camera as tcam
        scene = Scene.build(
            materials=[{"kind": "diffuse", "albedo_rgb": (0.7, 0.5, 0.3)}],
            lights=[{"kind": "point", "position": (2, 3, -2),
                     "spd_named": "stdillum-D65", "scale": 10.0}],
            spheres=[{"radius": 1.0, "material": 0}], device="cpu")
        camera = tcam.PerspectiveCamera.create((0, 0, -4), (8, 8),
                                               fov_y=40.0, look_at=(0, 0, 0))
        cfg = tinteg.RenderConfig(
            resolution=(8, 8), integrator="direct",
            sampler=tinteg.SamplerConfig(kind="sobol", spp=4))
        return scene, camera, cfg
    return trt.setup(4, (16, 16), "cpu")


@pytest.mark.parametrize("case", ["sphere_direct", "flagship_path"])
def test_resume_is_bitwise(tmp_path, case):
    """render(passes=2), checkpoint, load, render(film=...) equals a
    straight render bit for bit (one device, chunk 1)."""
    scene, camera, cfg = _resume_scene(case)
    straight, _ = tinteg.render(scene, camera, cfg)
    half, _ = tinteg.render(scene, camera, cfg, passes=2)
    ck = tck.RenderCheckpointer(str(tmp_path), every=2)
    assert ck.maybe_save(half, {"k": 1})
    loaded, meta = ck.restore(cfg.resolution, device="cpu")
    assert meta == {"k": 1} and loaded.spp_done == 2
    resumed, _ = tinteg.render(scene, camera, cfg, film=loaded)
    assert resumed.spp_done == straight.spp_done == 4
    assert torch.equal(resumed.rgb_sum, straight.rgb_sum)
    assert torch.equal(resumed.weight_sum, straight.weight_sum)


def test_restore_without_a_checkpoint_starts_an_empty_film(tmp_path):
    ck = tck.RenderCheckpointer(str(tmp_path / "new"), every=4)
    film, meta = ck.restore((5, 3), device="cpu")
    assert meta == {} and film.spp_done == 0
    assert film.rgb_sum.shape == (3, 5, 3) and not film.rgb_sum.any()
    assert not ck.maybe_save(tfilm.Film(film.rgb_sum, film.weight_sum, 3))


def test_pytree_roundtrip(tmp_path):
    """Nested dict/list/tuple leaves come back with their values, dtypes
    and structure."""
    tree = {"b": [torch.zeros(4), (torch.full((2,), 7.0),
                                   torch.arange(3, dtype=torch.int32))],
            "a": torch.ones(3, 2)}
    p = str(tmp_path / "tree.npz")
    tck.save_pytree(p, tree)
    like = {"a": torch.empty(3, 2), "b": [torch.empty(4), (
        torch.empty(2), torch.empty(3, dtype=torch.int32))]}
    back = tck.load_pytree(p, like)
    assert isinstance(back["b"][1], tuple)
    assert back["b"][1][1].dtype == torch.int32
    for got, want in ((back["a"], tree["a"]), (back["b"][0], tree["b"][0]),
                      (back["b"][1][0], tree["b"][1][0]),
                      (back["b"][1][1], tree["b"][1][1])):
        assert torch.equal(got, want)


def test_pytree_of_parameters_and_a_reference_file(tmp_path):
    """The port's parameter dict (convert.params_from_numpy) round-trips
    with requires_grad kept; a tree the reference saved loads into the
    port's structure (dict keys flatten in sorted order in both)."""
    rng = np.random.default_rng(5)
    arrays = {"albedo_coeffs": rng.normal(size=(4, 3)).astype(np.float32),
              "light_scale": np.full(1, 6.0, np.float32),
              "emission": rng.uniform(size=(4, 471)).astype(np.float32)}
    params = convert.params_from_numpy(arrays, device="cpu")
    p = str(tmp_path / "params.npz")
    tck.save_pytree(p, params)
    back = tck.load_pytree(p, params)
    for k in arrays:
        assert torch.equal(back[k], params[k]) and back[k].requires_grad
    jp = str(tmp_path / "jax.npz")
    jck.save_pytree(jp, {k: jnp.asarray(v) for k, v in arrays.items()})
    from_jax = tck.load_pytree(jp, params)
    for k, v in arrays.items():
        np.testing.assert_array_equal(from_jax[k].detach().numpy(), v)


# --- metrics -----------------------------------------------------------------

def test_metrics_logger_writes_the_reference_records(tmp_path):
    p = str(tmp_path / "metrics.jsonl")
    ml = tmetrics.MetricsLogger(path=p)
    ml.log("pass", seconds=0.5, rays_per_sec=1e6)
    ml.log("done", spp=3)
    ml.close()
    recs = [json.loads(line) for line in open(p)]
    assert [r["event"] for r in recs] == ["pass", "done"]
    assert recs[0]["rays_per_sec"] == 1e6 and recs[1]["spp"] == 3
    assert set(recs[0]) == {"event", "t", "seconds", "rays_per_sec"}


def test_render_meter_logs_one_record_a_pass(tmp_path):
    p = str(tmp_path / "m.jsonl")
    meter = tmetrics.RenderMeter(100, 7, tmetrics.MetricsLogger(path=p))
    for _ in range(3):
        assert meter.pass_done(block_on=torch.zeros(2)) >= 0.0
    meter.logger.close()
    recs = [json.loads(line) for line in open(p)]
    assert [r["index"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert r["rays_per_sec"] == pytest.approx(
            700 / max(r["seconds"], 1e-9))


def test_timer_reads_and_laps():
    t = tmetrics.Timer()
    sum(range(10000))
    assert 0 <= t.seconds() <= t.ms() <= t.us() <= t.ns()
    assert t.lap() >= 0 and t.seconds() >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tmetrics.trace("nothing", None):
        pass
    assert not list(tmp_path.iterdir())
    with tmetrics.trace("render_block", str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "tr" / "render_block.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "render_block" in names


# --- scene config ------------------------------------------------------------

def test_scene_config_file_renders_as_the_reference(tmp_path):
    """The reference's test_scene_config_file spec through load_scene_file
    in both packages: the same render within 2e-3*max."""
    path = _write_json(tmp_path, CONFIG_FILE_SPEC)
    scene, camera, cfg = tcfg.load_scene_file(path, device="cpu")
    assert scene.spheres is not None and scene.disks is not None
    assert cfg == tcfg.build_render_config(CONFIG_FILE_SPEC["render"])
    js, jc, jr = jcfg.load_scene_file(path)
    got = _resolved(*tinteg.render(scene, camera, cfg))
    want = _resolved(*jinteg.render(js, jc, jr))
    assert want.sum() > 0
    _close_to_golden(got, want)


def test_obj_scene_file_with_octree_renders_as_the_reference(tmp_path):
    """A JSON scene naming an OBJ (octree on by default): the same tree as
    the reference's, and the same render within 2e-3*max."""
    v, f, _ = jmesh_gen.displaced_icosphere(2)
    obj = tmp_path / "ico.obj"
    jobj.save_obj(obj, v, f)
    path = _write_json(tmp_path, _obj_spec(obj))
    scene, camera, cfg = tcfg.load_scene_file(path, device="cpu")
    js, jc, jr = jcfg.load_scene_file(path)
    assert scene.packed_octree is not None
    assert scene.octree.info() == js.octree.info()
    got = _resolved(*tinteg.render(scene, camera, cfg))
    want = _resolved(*jinteg.render(js, jc, jr))
    assert want.max() > 0.01
    _close_to_golden(got, want)


def test_render_config_defaults_match_the_reference():
    for spec in ({}, CONFIG_FILE_SPEC["render"],
                 {"sampler": {"kind": "independent", "seed": 3},
                  "lambda_mode": "uniform", "clamp": 0.5,
                  "sensor": "canon_eos_5d", "filter": "lanczos",
                  "filter_radius": [1.0, 2.0], "rr_start": 2}):
        got, want = tcfg.build_render_config(spec), \
            jcfg.build_render_config(spec)
        for field in ("resolution", "integrator", "max_depth", "rr_start",
                      "lambda_mode", "filter_name", "filter_radius",
                      "sensor_name", "clamp"):
            assert getattr(got, field) == getattr(want, field), field
        for field in ("kind", "spp", "xs", "ys", "seed", "jitter"):
            assert getattr(got.sampler, field) == getattr(want.sampler,
                                                          field), field


@pytest.mark.parametrize("spec", [
    {"kind": "perspective", "fov_y": 50.0, "lens_radius": 0.05,
     "focal_distance": 3.0},
    {"kind": "orthographic", "window": [3.0, 2.0]},
    {"kind": "pinhole", "sensor_size": [0.036, 0.024]},
    {"kind": "thinlens"}], ids=lambda s: s["kind"])
def test_build_camera_matches_the_reference(spec):
    """Every camera kind from a spec (look-at placement): the same rays."""
    spec = {**spec, "position": [0.3, 0.5, -3.0], "look_at": [0, 0, 0]}
    got = tcfg.build_camera(spec, (12, 8))
    want = jcfg.build_camera(spec, (12, 8))
    rng = np.random.default_rng(0)
    pp = (rng.uniform(0, 1, (50, 2)) * [12, 8]).astype(np.float32)
    u = rng.uniform(0, 1, (50, 2)).astype(np.float32)
    o, d = got.generate_rays(T(pp), T(u))
    jo, jd = want.generate_rays(jnp.asarray(pp), jnp.asarray(u))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)


def _shapes_spec(tmp_path, case):
    spec = {"materials": [{"kind": "diffuse", "albedo_rgb": [0.7, 0.7, 0.7],
                           "use_texture": True},
                          {"kind": "diffuse", "albedo_rgb": [0.2, 0.5, 0.2]},
                          {"kind": "diffuse", "albedo_rgb": [0.5, 0.2, 0.2]},
                          {"kind": "diffuse", "albedo_rgb": [0, 0, 0],
                           "emission_rgb": [1, 1, 1]},
                          {"kind": "diffuse", "albedo_rgb": [0.9, 0.9, 0.9]},
                          {"kind": "diffuse", "albedo_rgb": [0.1, 0.1, 0.9]}],
            "lights": [{"kind": "ambient", "spd_named": "stdillum-E",
                        "scale": 1.0}]}
    if case == "every_kind_checker":
        spec["shapes"] = [
            {"kind": "sphere", "radius": 0.5, "material": 1,
             "transform": {"translate": [1, 0, 0]}},
            {"kind": "cylinder", "radius": 0.3, "z_min": -0.5, "z_max": 0.5,
             "material": 2, "transform": {"rotate_deg": [90, 0, 0]}},
            {"kind": "disk", "radius": 0.8, "inner_radius": 0.2,
             "material": 0, "transform": {"translate": [0, -1, 0],
                                          "rotate_deg": [-90, 0, 0],
                                          "scale": 1.5}},
            {"kind": "cornell_box", "size": 4.0, "material_base": 1},
            {"kind": "box", "lo": [-0.3, -0.9, -0.3], "hi": [0.3, -0.4, 0.3],
             "material": 5},
            {"kind": "uv_sphere", "center": [-1, 0.5, 0], "radius": 0.4,
             "material": 0}]
        spec["texture"] = {"kind": "checker", "res": 32,
                           "c0": [0.8, 0.1, 0.1], "c1": [0.1, 0.1, 0.8]}
        spec["backface_cull_dir"] = [0.0, 0.0, 1.0]
    else:
        png = tmp_path / "tex.png"
        jimage.write_png(png, np.random.default_rng(1).uniform(
            0, 1, (16, 24, 3)).astype(np.float32))
        spec["shapes"] = [{"kind": "uv_sphere", "radius": 1.0,
                           "material": 0}]
        spec["texture"] = {"kind": "image", "path": str(png)}
        spec["use_octree"] = False
    return spec


@pytest.mark.parametrize("case", ["every_kind_checker", "image_texture"])
def test_build_scene_matches_the_reference(tmp_path, case):
    """Every shape kind the reference accepts (spheres, cylinders, disks
    with transforms; the Cornell box with a material base, a box and a uv
    sphere merged into one mesh), both textures and backface culling: the
    scene's tables equal the reference's, and one pass renders alike."""
    spec = _shapes_spec(tmp_path, case)
    scene = tcfg.build_scene(spec, device="cpu")
    js = jcfg.build_scene(spec)
    for name in ("positions", "uvs", "normals"):
        np.testing.assert_array_equal(getattr(scene.mesh, name).numpy(),
                                      np.asarray(getattr(js.mesh, name)))
    np.testing.assert_array_equal(scene.mesh.indices.numpy(),
                                  np.asarray(js.mesh.indices))
    np.testing.assert_array_equal(scene.mesh_tri_mat.numpy(),
                                  np.asarray(js.mesh_tri_mat))
    np.testing.assert_allclose(scene.texture.numpy(), np.asarray(js.texture),
                               rtol=1e-6, atol=1e-6)
    assert (scene.octree is None) == (js.octree is None)
    if case == "every_kind_checker":
        np.testing.assert_array_equal(scene.tri_mask.numpy(),
                                      np.asarray(js.tri_mask))
        for table in ("spheres", "cylinders", "disks"):
            np.testing.assert_array_equal(
                getattr(scene, table).o2w.numpy(),
                np.asarray(getattr(js, table).o2w))
    rcfg = {"resolution": [12, 12], "integrator": "direct",
            "sampler": {"kind": "sobol", "spp": 1}}
    cam = {"position": [0.2, 0.3, -3.5], "look_at": [0, 0, 0]}
    cfg, jcf = tcfg.build_render_config(rcfg), jcfg.build_render_config(rcfg)
    got = _resolved(*tinteg.render(scene, tcfg.build_camera(cam, (12, 12)),
                                   cfg))
    want = _resolved(*jinteg.render(js, jcfg.build_camera(cam, (12, 12)),
                                    jcf))
    assert want.max() > 0.01
    _close_to_golden(got, want)


def test_unknown_shape_kind_raises():
    with pytest.raises(ValueError, match="unknown shape kind"):
        tcfg.build_scene({"materials": [{"kind": "diffuse"}],
                          "shapes": [{"kind": "teapot"}]}, device="cpu")


# --- scene_intersect's counter ----------------------------------------------

def test_scene_intersect_stats_counts_as_the_reference():
    """stats=True returns the reference's third output: F a ray for the
    brute mesh, the plain traversal's tests for the octree, 0 without a
    mesh; stats=False gives None in its place."""
    scenes = tst.shape_scenes("cpu")
    o, d = tst.camera_rays(12, "cpu")
    t_max = torch.full((144,), float("inf"))
    brute, octree = scenes["mesh_brute"], scenes["mesh_octree"]
    _, _, tests = tscene_mod.scene_intersect(brute, o, d, t_max, stats=True)
    assert tests.dtype == torch.int32
    assert (tests == brute.mesh.n_triangles).all()
    _, _, tests = tscene_mod.scene_intersect(octree, o, d, t_max, stats=True)
    plain = toct.octree_traverse(o, d, t_max, octree.packed_octree.tree,
                                 octree.packed_octree.tri_verts)
    assert torch.equal(tests, plain[4].to(torch.int32)) and tests.sum() > 0
    _, _, tests = tscene_mod.scene_intersect(scenes["sphere"], o, d, t_max,
                                             stats=True)
    assert not tests.any()
    assert tscene_mod.scene_intersect(octree, o, d, t_max)[2] is None


SHAPE_NAMES = ["sphere", "cylinder", "disk", "mesh_octree", "mesh_brute"]


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_shape_test_scene_matches_the_reference(name):
    """Each shape_test scene's pixel-centre rays: the hit mask exactly,
    normals and uvs within 1e-5, and for the brute mesh the test counts
    exactly, against the reference's scene_intersect."""
    res = 24
    scene = tst.shape_scenes("cpu")[name]
    o, d = tst.camera_rays(res, "cpu")
    normal, uv, valid, _, tests = tst.shade(scene, o, d)
    jscene = _reference_shape_scenes()[name]
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    si, _, jtests = jscene_mod.scene_intersect(jscene, jo, jd,
                                               jnp.full((res * res,), jnp.inf))
    jvalid = np.asarray(si.valid)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert 0.05 < jvalid.mean() < 0.95
    jn = np.where(jvalid[:, None], (np.asarray(si.n) + 1.0) / 2.0, 0.0)
    np.testing.assert_allclose(normal.numpy(), jn, atol=1e-5, rtol=0)
    juv = np.where(jvalid[:, None], np.asarray(si.uv), 0.0)
    np.testing.assert_allclose(uv.numpy()[:, :2], juv, atol=1e-5, rtol=0)
    if name != "mesh_octree":
        np.testing.assert_array_equal(tests.numpy(), np.asarray(jtests))


def _reference_shape_scenes():
    """The reference app's five scenes, built as its main() builds them."""
    from computational_ray_tracer_tpu.models.scene import Scene
    from computational_ray_tracer_tpu.ops import shapes as jshp
    from computational_ray_tracer_tpu.ops import triangle as jtri
    mats = [{"kind": "diffuse", "albedo_rgb": (0.7, 0.7, 0.7)}]
    lights = [{"kind": "ambient", "spd_named": "stdillum-E", "scale": 1.0}]
    pos, idx, uv = jmesh_gen.uv_sphere((0, 0, 0), 1.0, 24, 48)
    mesh = jtri.MeshData.build(pos, idx, uvs=uv)
    zeros = jnp.zeros(mesh.n_triangles, jnp.int32)
    return {
        "sphere": Scene.build(mats, lights, spheres=[
            {"radius": 1.0, "z_min": -0.8, "z_max": 0.9,
             "phi_max": 5.5, "material": 0}]),
        "cylinder": Scene.build(mats, lights, cylinders=[
            {"radius": 0.7, "z_min": -1.0, "z_max": 1.0, "material": 0,
             "transform": jshp.make_transform(rotate_deg=(90, 0, 0))}]),
        "disk": Scene.build(mats, lights, disks=[
            {"radius": 1.2, "inner_radius": 0.3, "material": 0,
             "transform": jshp.make_transform(rotate_deg=(25, 0, 0))}]),
        "mesh_octree": Scene.build(mats, lights, mesh=(mesh, zeros),
                                   use_octree=True),
        "mesh_brute": Scene.build(mats, lights, mesh=(mesh, zeros),
                                  use_octree=False),
    }


# --- the apps ----------------------------------------------------------------

def test_shape_test_app_matches_the_reference(tmp_path):
    """shape_test.main at 16x16 in both packages: hit fractions and the
    brute-force test totals exactly, the octree agreeing with the brute
    force, the octree's info; the same images written."""
    got = tst.main(str(tmp_path / "t"), res=16, device="cpu")
    want = jst.main(str(tmp_path / "j"), res=16)
    for name in SHAPE_NAMES:
        assert got[name]["hit_fraction"] == want[name]["hit_fraction"]
    for name in ("sphere", "cylinder", "disk", "mesh_brute"):
        assert (got[name]["triangle_tests_total"]
                == want[name]["triangle_tests_total"])
    assert got["mesh_octree"]["octree"] == want["mesh_octree"]["octree"]
    assert got["octree_matches_brute"] and want["octree_matches_brute"]
    assert got["octree_speedup_tests"] > 1
    on_disk = json.loads((tmp_path / "t" / "shape_test.json").read_text())
    assert on_disk == json.loads(json.dumps(got))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))


def test_raytracer_app_matches_the_reference(tmp_path):
    """raytracer.main at 16x16, spp 2, a dump every pass, in both packages:
    film.npz within 2e-3*max (the pixels whose camera ray meets a mesh edge
    left out, chip_smoke.edge_pixels), the same files written, PNGs that
    decode to the resolved film, one metrics record a pass."""
    import chip_smoke
    out, jout = tmp_path / "t", tmp_path / "j"
    img = trt.main(str(out), spp=2, resolution=(16, 16), dump_every=1,
                   device="cpu")
    jrt.main(str(jout), spp=2, resolution=(16, 16), dump_every=1)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    got, _ = tck.load_film(str(out / "film.npz"), device="cpu")
    want, _ = jck.load_film(str(jout / "film.npz"))
    assert got.spp_done == int(want.spp_done) == 2
    scene, camera, cfg = trt.setup(2, (16, 16), "cpu")
    keep = ~(chip_smoke.edge_pixels(scene, camera, cfg, 0)
             | chip_smoke.edge_pixels(scene, camera, cfg, 1)).numpy()
    g = (got.rgb_sum / got.weight_sum[..., None]).numpy()
    w = np.asarray(want.rgb_sum) / np.asarray(want.weight_sum)[..., None]
    atol = 2e-3 * float(w.max())
    assert float(np.abs(g - w)[keep].max()) <= atol
    np.testing.assert_allclose(got.weight_sum.numpy(),
                               np.asarray(want.weight_sum), rtol=1e-5)
    for name in ("final.png", "progress_0002.png"):
        np.testing.assert_array_equal(timage.read_image(out / name),
                                      timage.to_uint8(img) / np.float32(255))
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["index"] for r in recs] == [1, 2]


def test_raytracer_app_resumes_its_checkpoint(tmp_path):
    """A run stopped after one pass and checkpointed, then main() again on
    the same out-dir, ends with the straight run's film bit for bit."""
    trt.main(str(tmp_path / "a"), spp=2, resolution=(8, 8), device="cpu")
    scene, camera, cfg = trt.setup(2, (8, 8), "cpu")
    half, _ = tinteg.render(scene, camera, cfg, passes=1)
    assert tck.RenderCheckpointer(str(tmp_path / "b"), every=1).maybe_save(
        half)
    trt.main(str(tmp_path / "b"), spp=2, resolution=(8, 8), device="cpu")
    a = np.load(tmp_path / "a" / "film.npz")
    b = np.load(tmp_path / "b" / "film.npz")
    for k in ("rgb_sum", "weight_sum", "spp_done"):
        np.testing.assert_array_equal(a[k], b[k])
    recs = [json.loads(line) for line in open(tmp_path / "b" / "metrics.jsonl")]
    assert len(recs) == 1


def test_flagship_spec_is_the_reference_spec():
    assert trt.flagship_scene_spec() == jrt.flagship_scene_spec()
    assert trt.flagship_scene_spec(3.0) == jrt.flagship_scene_spec(3.0)


# The eight apps the dispatcher refused until they were ported; it now
# dispatches every one of them.
FORMERLY_UNPORTED = ["sampler_test", "filter_film_test", "spectrum_color",
                     "montecarlo_test", "polygon_app", "crossbridge",
                     "ode_app", "plotter_demo"]


@pytest.mark.parametrize("app", FORMERLY_UNPORTED)
def test_dispatcher_refuses_an_app_not_yet_ported(app, capsys, monkeypatch):
    """The test kept its name from when these apps were refused. It now
    checks two things for each formerly unported app: the dispatcher
    refuses a name it has no app for (``<app>_2``, exit code 2), and it
    dispatches ``<app>`` itself to that app's ``main`` on the device
    asked."""
    import importlib
    from computational_ray_tracer_tpu.apps import APP_NAMES as J_APPS
    assert app in J_APPS and app in APP_NAMES
    with pytest.raises(SystemExit) as err:
        tdispatch.main([app + "_2", "--out", "x", "--device", "cpu"])
    assert err.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    calls = []
    mod = importlib.import_module(
        f"computational_ray_tracer_tpu_torch.apps.{app}")
    monkeypatch.setattr(mod, "main", lambda **kw: calls.append(kw) or {})
    assert tdispatch.main([app, "--out", "x", "--device", "cpu"]) == {}
    assert calls == [{"outdir": "x", "device": "cpu"}]


@pytest.mark.parametrize("argv,device", [
    (["shape_test", "--out", "o"], "cuda"),
    (["raytracer", "--out", "o", "--device", "cpu"], "cpu")])
def test_dispatcher_runs_the_app_on_the_device_asked(monkeypatch, argv,
                                                     device):
    """The card unless --device says otherwise; --out is the out-dir."""
    import importlib
    calls = []
    mod = importlib.import_module(
        f"computational_ray_tracer_tpu_torch.apps.{argv[0]}")
    monkeypatch.setattr(mod, "main", lambda **kw: calls.append(kw) or {})
    assert tdispatch.main(argv) == {}
    assert calls == [{"outdir": "o", "device": device}]
