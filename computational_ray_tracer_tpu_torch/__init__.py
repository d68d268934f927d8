"""PyTorch/CUDA port of the spectral path tracer.

The JAX package ``computational_ray_tracer_tpu`` beside this one is the
reference every module here is held against. This package imports torch and
numpy only, never jax nor the reference package: it keeps its own copies of
the reference's data files (``ops/data/``) and of the host helpers it needs
(``ops/spectra_data.py``, ``ops/rng.py``'s Sobol generator,
``ops/sobol_quality.py``, ``utils/mesh_gen.py``).

It covers the whole reference: ``render()`` with every integrator,
sampler, filter, camera and shape kind, the brute-force and octree mesh
paths and the spectral interpolation on hand-written CUDA kernels
(``csrc/``), inverse rendering (``models/inverse.py``), sharded rendering
and training over ``torch.distributed`` (``parallel/``), scenes as data,
the spectral, colour, sampling and Monte Carlo tools, 2D geometry
(``geometry2d/``), the simulations (``models/simulation.py``) and the ten
apps (``apps/``).
"""

from computational_ray_tracer_tpu_torch.ops import (  # noqa: E402,F401
    color, rng, sampling, spectrum)
