"""The plain reference of the ``mesh.deep512`` cell: the untextured mesh
bench scene in an octree under the path integrator (MIS) at depth 8,
built on ``reference/textured.py`` as it is. Plain PyTorch in float32
(TF32 off, :func:`textured.float32`), nothing of the port, no kernel; its
intermediates are stored through ``reference/precision.py``, so the
control lowers them too.

The port compacts its rays between bounces; this reference bounces the
full wavefront, whose values compaction keeps. Its film is
``textured.path_film`` on :func:`untextured`'s scene; :func:`alive_counts`
counts the rays entering each bounce of one whole pass. Departures from
the frozen copy: none beyond ``textured.py``'s (the any-hit shadow rays
in the octree; its texture fetch, which no material takes here)."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import textured
from gpubench.reference.crt.models import integrator as integ

# The texture the untextured scene carries: no material uses it.
_NO_TEXTURE = np.zeros((2, 2, 3), np.float32)


def untextured(scene):
    """The frozen copy's ``scene`` as a :class:`textured.TexturedScene`
    whose materials all leave the texture alone."""
    return textured.attach(scene, _NO_TEXTURE, [])


def alive_counts(ts, camera, cfg, sample_idx):
    """The alive rays entering each of the cfg.max_depth bounces of one
    whole pass at the int ``sample_idx``: [int] of that length, through
    ``textured``'s own camera wavefront and bounce."""
    counts = []
    with torch.no_grad(), textured.float32():
        pixel, wl, _, o, d = integ.camera_wavefront(
            camera, cfg, integ.make_filter(cfg), sample_idx, ts.device)
        state = integ._init_path_state(ts.scene, o, d, wl)
        for depth in range(cfg.max_depth):
            counts.append(int(state["alive"].sum()))
            state = textured._bounce_step(ts, cfg, state, depth, pixel,
                                          sample_idx)
    return counts
