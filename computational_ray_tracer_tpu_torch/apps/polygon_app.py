"""Polygon app (``computational_ray_tracer_tpu/apps/polygon_app.py``): a
random simple polygon, its ears and ear-clipping triangulation, the
visibility polygons of guards and their coverage, drawn to
``polygon.png`` and exported to ``polygon.txt``; report ``polygon.json``.
The polygon and the coverage samples come from a NumPy ``Generator``
(the reference's draws); the ray casts and point-in-polygon tests run on
``device``."""

from __future__ import annotations

import json
import os

import numpy as np


def main(outdir="out", n_vertices=14, n_guards=2, seed=4, device="cuda"):
    from computational_ray_tracer_tpu_torch.geometry2d import polygon as pg
    from computational_ray_tracer_tpu_torch.geometry2d import visibility as vis
    from computational_ray_tracer_tpu_torch.utils import plot

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    poly = pg.Polygon.random_simple(n_vertices, rng=rng)
    poly.make_ccw()

    tris = poly.triangulate()
    ears = poly.ears()
    guards = [poly.centroid()]
    for _ in range(n_guards - 1):
        guards.append(poly.v[int(rng.integers(len(poly)))] * 0.9
                      + poly.centroid() * 0.1)
    vis_polys = [vis.visibility_polygon(poly, g, device=device)
                 for g in guards]
    coverage = vis.guard_coverage(poly, guards, rng=rng, device=device)

    g = plot.Graph2D(title="Polygon: triangulation + visibility",
                     xlabel="x", ylabel="y")
    v = poly.v
    loop = np.vstack([v, v[:1]])
    g.plot_line(loop[:, 0], loop[:, 1], label="polygon")
    for t in tris:
        tv = v[list(t) + [t[0]]]
        g.plot_line(tv[:, 0], tv[:, 1], lw=0.5)
    for k, vp in enumerate(vis_polys):
        if len(vp.v):
            vp_loop = np.vstack([vp.v, vp.v[:1]])
            g.plot_line(vp_loop[:, 0], vp_loop[:, 1],
                        label=f"visibility {k}")
    gx = np.asarray(guards)
    g.plot_points(gx[:, 0], gx[:, 1], label="guards", s=40)
    g.save(os.path.join(outdir, "polygon.png"))

    poly.save_txt(os.path.join(outdir, "polygon.txt"))
    report = {
        "n_vertices": len(poly),
        "area": float(poly.area()),
        "is_ccw": bool(poly.is_ccw()),
        "n_triangles": len(tris),
        "n_ears": len(ears),
        "guard_coverage": float(coverage),
        "triangulation_area_check": float(
            sum(pg.Polygon(v[list(t)]).area() for t in tris)),
    }
    with open(os.path.join(outdir, "polygon.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report
