"""The application suite (``computational_ray_tracer_tpu/apps/``): each app
is a module with ``main(outdir, ..., device)`` that renders images, plots
and JSON artifacts headlessly, on the card by default.

| reference app           | module            |
|-------------------------|-------------------|
| RayTracerTestApp        | raytracer         |
| ShapeTestApp            | shape_test        |
| SamplerTestApp          | sampler_test      |
| FilterFilmTestApp       | filter_film_test  |
| SpectrumColorTestApp    | spectrum_color    |
| MonteCarlosTestApp      | montecarlo_test   |
| PolygonApp1             | polygon_app       |
| MuscleCrossbridgeApp    | crossbridge       |
| ODESolverApp            | ode_app           |
| PlotterTestApp          | plotter_demo      |

Run: ``python -m computational_ray_tracer_tpu_torch.apps <name> [--out DIR]
[--device cpu]``.
"""

APP_NAMES = ["raytracer", "shape_test", "sampler_test", "filter_film_test",
             "spectrum_color", "montecarlo_test", "polygon_app",
             "crossbridge", "ode_app", "plotter_demo"]


def uniform(key, shape, device, lo=0.0, hi=1.0):
    """float32 uniforms on [lo, hi) from a ``torch.Generator`` on
    ``device`` seeded with ``key``: the draws the reference app makes with
    ``jax.random.PRNGKey(key)`` (other values, the same distribution)."""
    import torch
    g = torch.Generator(device=device).manual_seed(key)
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)
