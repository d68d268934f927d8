"""The 327,680-triangle test mesh of the mesh bench: the frozen copy's
``mesh_gen.icosphere`` with four octaves of sinusoidal radial
displacement (``utils/mesh_gen.displaced_icosphere`` of the package the
port was made from), kept between runs under ``gpubench/.cache/assets/``."""

import math

import numpy as np

from gpubench.reference.crt.utils import asset_cache, mesh_gen


def _displaced(subdiv, radius, center, amplitude, seed):
    verts, faces, uvs = mesh_gen.icosphere(subdiv, 1.0, (0.0, 0.0, 0.0))
    rng = np.random.RandomState(seed)
    disp = np.zeros(verts.shape[0])
    for octave in range(4):
        freq = 2.0 ** octave * 3.0
        k = rng.normal(size=(3, 3))
        phase = rng.uniform(0, 2 * math.pi, size=3)
        for j in range(3):
            disp += (amplitude / (2.0 ** octave)
                     * np.sin(freq * (verts @ k[j]) + phase[j]))
    verts = verts * (1.0 + disp[:, None] / 3.0)
    verts = np.asarray(center, np.float64) + radius * verts
    return (verts.astype(np.float32), faces.astype(np.int32),
            uvs.astype(np.float32))


def generate(subdiv=7, radius=1.0, center=(0.0, 0.0, 0.0), amplitude=0.15,
             seed=7):
    """(positions (V, 3) float32, faces (F, 3) int32, uvs (V, 2), None: one
    material); 20 * 4^subdiv faces."""
    center = tuple(float(c) for c in center)
    key = (f"displaced_icosphere_v1_s{subdiv}_r{radius}_c{center[0]}_"
           f"{center[1]}_{center[2]}_a{amplitude}_seed{seed}")
    pos, idx, uv = asset_cache.cached(
        key, lambda: _displaced(subdiv, radius, center, amplitude, seed),
        ("verts", "faces", "uvs"))
    return pos, idx, uv, None
