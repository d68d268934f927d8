"""The application suite (``computational_ray_tracer_tpu/apps/``): each app
is a module with ``main(outdir, ..., device)`` that renders images and JSON
artifacts headlessly.

| reference app           | module            | in this package     |
|-------------------------|-------------------|---------------------|
| RayTracerTestApp        | raytracer         | ported              |
| ShapeTestApp            | shape_test        | ported              |
| SamplerTestApp          | sampler_test      | not yet ported      |
| FilterFilmTestApp       | filter_film_test  | not yet ported      |
| SpectrumColorTestApp    | spectrum_color    | not yet ported      |
| MonteCarlosTestApp      | montecarlo_test   | not yet ported      |
| PolygonApp1             | polygon_app       | not yet ported      |
| MuscleCrossbridgeApp    | crossbridge       | not yet ported      |
| ODESolverApp            | ode_app           | not yet ported      |
| PlotterTestApp          | plotter_demo      | not yet ported      |

Run: ``python -m computational_ray_tracer_tpu_torch.apps <name> [--out DIR]
[--device cpu]`` (the card by default).
"""

APP_NAMES = ["raytracer", "shape_test"]
