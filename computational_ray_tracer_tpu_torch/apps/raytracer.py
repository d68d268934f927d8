"""The flagship renderer app (``computational_ray_tracer_tpu/apps/
raytracer.py``): progressive spectral path tracing of the Cornell box and a
mirror sphere, with checkpoints and resume, per-pass metrics and periodic
PNG dumps.

Into ``outdir`` go ``metrics.jsonl`` (one ``pass`` record a pass),
``progress_NNNN.png`` and a checkpoint (``film.npz``) every ``dump_every``
passes, then ``final.png`` and the final ``film.npz``. A ``film.npz``
already in ``outdir`` is resumed from.
"""

from __future__ import annotations

import os


def flagship_scene_spec(light_scale=6.0):
    return {
        "render": {"resolution": [256, 256], "integrator": "path",
                   "max_depth": 5,
                   "sampler": {"kind": "sobol", "spp": 64},
                   "filter": "gaussian", "filter_radius": [0.5, 0.5]},
        "camera": {"kind": "perspective", "position": [0, 0, -2.8],
                   "look_at": [0, 0, 0], "fov_y": 50.0},
        "materials": [
            {"kind": "diffuse", "albedo_rgb": [0.73, 0.73, 0.73]},
            {"kind": "diffuse", "albedo_rgb": [0.65, 0.05, 0.05]},
            {"kind": "diffuse", "albedo_rgb": [0.12, 0.45, 0.15]},
            {"kind": "diffuse", "albedo_rgb": [0, 0, 0],
             "emission_rgb": [1.0, 0.85, 0.6], "emission_scale": light_scale},
            {"kind": "conductor", "albedo_rgb": [0.95, 0.95, 0.95],
             "metal": "metal-Ag"},
        ],
        "lights": [{"kind": "quad", "corner": [-0.5, 0.99, -0.5],
                    "edge1": [1.0, 0, 0], "edge2": [0, 0, 1.0],
                    "rgb": [1.0, 0.85, 0.6], "scale": light_scale}],
        "shapes": [
            {"kind": "cornell_box", "size": 2.0},
            {"kind": "sphere", "radius": 0.4, "material": 4,
             "transform": {"translate": [-0.35, -0.6, 0.3]}},
        ],
        "use_octree": False,
    }


def setup(spp=None, resolution=None, device="cuda"):
    """(scene, camera, cfg) of the flagship spec, with ``spp`` and
    ``resolution`` in place of its own where given."""
    from computational_ray_tracer_tpu_torch.utils import config as cfgmod
    spec = flagship_scene_spec()
    if spp:
        spec["render"]["sampler"]["spp"] = spp
    if resolution:
        spec["render"]["resolution"] = list(resolution)
    cfg = cfgmod.build_render_config(spec["render"])
    camera = cfgmod.build_camera(spec["camera"], cfg.resolution)
    return cfgmod.build_scene(spec, device), camera, cfg


def main(outdir="out", spp=None, resolution=None, dump_every=16,
         device="cuda"):
    """Render the flagship scene on ``device`` into ``outdir``; returns the
    final sRGB image (H, W, 3) as numpy."""
    from computational_ray_tracer_tpu_torch.models import integrator as integ
    from computational_ray_tracer_tpu_torch.utils import (checkpoint, image,
                                                          metrics)

    os.makedirs(outdir, exist_ok=True)
    scene, camera, cfg = setup(spp, resolution, device)
    ck = checkpoint.RenderCheckpointer(outdir, every=dump_every)
    film, _ = ck.restore(cfg.resolution, device=scene.device)
    sensor = integ.make_sensor(cfg)
    meter = metrics.RenderMeter(
        cfg.resolution[0] * cfg.resolution[1],
        1 + (cfg.max_depth - 1) + cfg.max_depth,
        metrics.MetricsLogger(path=os.path.join(outdir, "metrics.jsonl")))

    def progress(i, film_):
        meter.pass_done(block_on=film_.rgb_sum)
        if (i + 1) % dump_every == 0:
            ck.maybe_save(film_)
            image.write_png(os.path.join(outdir, f"progress_{i+1:04d}.png"),
                            film_.resolve(sensor))

    try:
        film, sensor = integ.render(scene, camera, cfg, film=film,
                                    progress=progress)
    finally:
        meter.logger.close()
    img = film.resolve(sensor).cpu().numpy()
    image.write_png(os.path.join(outdir, "final.png"), img)
    checkpoint.save_film(os.path.join(outdir, "film.npz"), film)
    print(f"rendered {int(film.spp_done)} spp -> {outdir}/final.png")
    return img
