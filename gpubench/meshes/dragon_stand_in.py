"""The 872,320-triangle stand-in for the Stanford dragon (the frozen copy's
``mesh_gen.dragon_stand_in``), kept between runs under
``gpubench/.cache/assets/``."""

from gpubench.reference.crt.utils import mesh_gen


def generate(target_tris=870_000, scale=15.0, seed=11):
    """(positions (V, 3) float32, faces (F, 3) int32, uvs (V, 2), None: one
    material)."""
    pos, idx, uv = mesh_gen.dragon_stand_in(target_tris, scale, seed)
    return pos, idx, uv, None
