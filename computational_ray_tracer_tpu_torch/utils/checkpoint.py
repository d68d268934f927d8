"""Checkpoint and resume of progressive renders and of parameter trees
(``computational_ray_tracer_tpu/utils/checkpoint.py``), as npz archives.

A film is saved under the reference's keys (``rgb_sum``, ``weight_sum``,
``spp_done`` as int32, ``meta`` as JSON text), so a film either package
writes, the other loads. Resume is exact: the samplers are counter-based,
so sample i has the same value whenever it is rendered, and ``render()``
continues at ``film.spp_done``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import film as filmmod


def save_film(path, film: filmmod.Film, meta=None):
    np.savez(path,
             rgb_sum=film.rgb_sum.detach().cpu().numpy(),
             weight_sum=film.weight_sum.detach().cpu().numpy(),
             spp_done=np.asarray(int(film.spp_done), np.int32),
             meta=json.dumps(meta or {}))


def load_film(path, device="cuda"):
    """(Film on ``device``, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        film = filmmod.Film(torch.as_tensor(z["rgb_sum"], device=device),
                            torch.as_tensor(z["weight_sum"], device=device),
                            int(z["spp_done"]))
        meta = json.loads(str(z["meta"]))
    return film, meta


def _flatten(tree):
    """(leaves, structure) of a nested dict/list/tuple; dict keys in sorted
    order, as ``jax.tree_util`` flattens them."""
    if isinstance(tree, dict):
        leaves, spec = [], {}
        for k in sorted(tree):
            sub, spec[k] = _flatten(tree[k])
            leaves += sub
        return leaves, spec
    if isinstance(tree, (list, tuple)):
        leaves, spec = [], []
        for x in tree:
            sub, s = _flatten(x)
            leaves += sub
            spec.append(s)
        return leaves, spec
    return [tree], "*"


def _unflatten(like, leaves):
    """``like`` with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _as_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_pytree(path, tree):
    """A nested dict/list/tuple of tensors (or arrays) as ``leaf_i``
    entries plus its structure as JSON text (``treedef``)."""
    leaves, spec = _flatten(tree)
    arrays = {f"leaf_{i}": _as_numpy(x) for i, x in enumerate(leaves)}
    arrays["treedef"] = np.asarray(json.dumps(spec))
    np.savez(path, **arrays)


def load_pytree(path, like):
    """The tree saved by save_pytree, in the structure of ``like``: each
    leaf a tensor on the device of ``like``'s leaf, with its dtype and its
    ``requires_grad``."""
    leaves, _ = _flatten(like)
    with np.load(path, allow_pickle=False) as z:
        out = []
        for i, ref in enumerate(leaves):
            a = z[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                t = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                out.append(t.requires_grad_(ref.requires_grad))
            else:
                out.append(torch.as_tensor(a))
    return _unflatten(like, iter(out))


class RenderCheckpointer:
    """Periodic checkpoints of a progressive render: ``maybe_save`` writes
    ``directory/film.npz`` whenever ``spp_done`` is a multiple of
    ``every``; ``restore`` loads it, or starts an empty film."""

    def __init__(self, directory, every=16):
        self.directory = directory
        self.every = every
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self):
        return os.path.join(self.directory, "film.npz")

    def maybe_save(self, film: filmmod.Film, meta=None):
        if int(film.spp_done) % self.every == 0:
            save_film(self.path, film, meta)
            return True
        return False

    def restore(self, resolution, device="cuda"):
        """(film on ``device``, meta): the saved film, or an empty one."""
        if os.path.exists(self.path):
            return load_film(self.path, device)
        return filmmod.Film.create(resolution, device=device), {}
