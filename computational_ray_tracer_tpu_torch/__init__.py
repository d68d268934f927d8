"""PyTorch/CUDA port of the spectral path tracer.

The JAX package ``computational_ray_tracer_tpu`` beside this one is the
reference every module here is held against. This package imports torch and
numpy only, never jax: the reference's data files are read by path, and the
small host helpers it needs are ported (``ops/spectra_data.py``,
``ops/rng.py``'s Sobol generator, ``utils/mesh_gen.py``).

What is ported: ``render()`` with every integrator, sampler, filter,
camera and shape kind of the reference, the brute-force and octree mesh
paths and the spectral interpolation on hand-written CUDA kernels
(``csrc/``), inverse rendering (``models/inverse.py``) and sharded
rendering and training over ``torch.distributed`` (``parallel/``).
ROADMAP.md lists what is left.
"""
