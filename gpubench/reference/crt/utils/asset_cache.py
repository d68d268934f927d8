"""On-disk cache of generated geometry (``computational_ray_tracer_tpu/
utils/asset_cache.py``): regenerating the ~870k-triangle dragon stand-in
or building an octree over it takes seconds to minutes of host NumPy, so
``utils/mesh_gen`` and ``ops/octree`` keep them under
``gpubench/.cache/assets/<key>.npz`` in this frozen copy.

Every key starts with ``PREFIX``, so this package and the JAX package never
read each other's files. A key must encode every generation parameter: the
cache has no invalidation beyond the key, so bump the ``v`` in a key when a
generator's output changes.
"""

from __future__ import annotations

import os

import numpy as np

PREFIX = "torch_"
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), ".cache", "assets")


def cache_path(key: str) -> str:
    return os.path.join(_CACHE_DIR, f"{PREFIX}{key}.npz")


def load(key: str):
    """The dict of arrays cached under ``key``, or None (also for a file
    that cannot be read, which is then regenerated)."""
    path = cache_path(key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None


def store(key: str, **arrays) -> None:
    """Cache named arrays under ``key``: written to a file of this process,
    then renamed, so a reader never sees a partial file. A failed write
    leaves no cache and raises nothing."""
    path = cache_path(key)
    tmp = path[:-len(".npz")] + f".tmp{os.getpid()}.npz"
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)


def cached(key: str, generate, names):
    """The arrays ``names`` from the cache, or ``generate()`` (a tuple in
    the order of ``names``), stored under ``key``."""
    hit = load(key)
    if hit is not None and all(n in hit for n in names):
        return tuple(hit[n] for n in names)
    out = generate()
    store(key, **dict(zip(names, out)))
    return out
