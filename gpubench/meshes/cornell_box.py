"""The Cornell box's walls and light quad (the frozen copy's
``mesh_gen.cornell_box``): 12 wall triangles and the 2 of the light, with
the per-triangle materials white, red, green and light."""

from gpubench.reference.crt.utils import mesh_gen


def generate(size=2.0):
    """(positions (V, 3) float32, faces (F, 3) int32, uvs (V, 2), per-
    triangle material ids (F,))."""
    pos, idx, uv, mats, _ = mesh_gen.cornell_box(size)
    return pos, idx, uv, mats
