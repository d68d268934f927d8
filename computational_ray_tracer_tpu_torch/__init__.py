"""PyTorch/CUDA port of the spectral path tracer.

The JAX package ``computational_ray_tracer_tpu`` beside this one is the
reference every module here is held against. This package imports torch and
numpy only, never jax: the reference's data files are read by path, and the
small host helpers it needs are ported (``ops/spectra_data.py``,
``ops/rng.py``'s Sobol generator, ``utils/mesh_gen.py``).

Port status (first slice): the Cornell path/MIS render through ``render()``
with the brute-force mesh intersection running on the hand-written CUDA
kernel ``csrc/mesh_intersect.cu`` on a GPU.
"""
