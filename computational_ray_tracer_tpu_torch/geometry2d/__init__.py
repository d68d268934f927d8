"""2D computational geometry (``computational_ray_tracer_tpu/geometry2d/``):
segment predicates, simple polygons and visibility polygons."""
