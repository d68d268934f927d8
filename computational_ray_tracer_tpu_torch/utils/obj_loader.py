"""Wavefront OBJ/MTL import (``computational_ray_tracer_tpu/utils/
obj_loader.py``): fan-triangulated faces, vertices split on unique (v, vt,
vn) index triples in first-use order, missing attributes defaulted, MTL
materials mapped onto the spectral material kinds, and a named model cache
that builds the port's ``MeshData`` on a device.

``load_obj`` parses with the C++ loader (``csrc/host/mesh_loader.cpp``,
built into ``build/libcrt_host.so``) unless ``native=False`` asks for the
Python parser, its plain version. There is no fallback: a failed build of
the host library raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from computational_ray_tracer_tpu_torch.kernels import build


def load_obj(path, native=None):
    """(positions (V, 3) f32, indices (F, 3) i32, normals (V, 3) f32 or
    None, uvs (V, 2) f32). ``native`` None or True: the C++ loader; False:
    the Python parser. The two give equal arrays for the numbers that one
    rounding to float32 and two (to float64, then float32) read alike."""
    if native is False:
        return _load_obj_python(path)
    return _load_obj_native(path)


def _mesh_arrays(m, with_uvs):
    """Copies of a filled ``CrtMesh``'s arrays."""
    nv, nt = m.n_verts, m.n_tris
    arr = lambda ptr, n, k, dt: (np.ctypeslib.as_array(ptr, (n, k)).copy()
                                 if n else np.zeros((0, k), dt))
    positions = arr(m.positions, nv, 3, np.float32)
    indices = arr(m.indices, nt, 3, np.int32)
    uvs = arr(m.uvs, nv, 2, np.float32) if with_uvs else None
    normals = (np.ctypeslib.as_array(m.normals, (nv, 3)).copy()
               if (m.has_normals and nv) else None)
    return positions, indices, normals, uvs


def _load_obj_native(path):
    lib = build.load_host_library()
    m = build.CrtMesh()
    rc = lib.crt_load_obj(str(path).encode(), ctypes.byref(m))
    if rc != 0:
        raise FileNotFoundError(f"crt_load_obj({path}) failed rc={rc}")
    try:
        return _mesh_arrays(m, True)
    finally:
        lib.crt_free_mesh(ctypes.byref(m))


def _parse_obj(path, directive=None):
    """(v, vt, vn lists, triangulated corners, one tag a triangle).
    ``directive(tokens, tag)`` sees every line that is not v/vt/vn/f and
    returns the tag of the faces after it; a face before any tag takes
    ``directive(None, None)``."""
    vs, vts, vns = [], [], []
    corners, tri_tags = [], []
    tag = None
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                vts.append([float(t[1]), float(t[2]) if len(t) > 2 else 0.0])
            elif t[0] == "vn":
                vns.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                face = []
                for c in t[1:]:
                    parts = c.split("/")
                    vi = int(parts[0])
                    vti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    vni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    face.append((vi, vti, vni))
                if tag is None and directive is not None:
                    tag = directive(None, None)
                for k in range(1, len(face) - 1):    # fan triangulation
                    corners.extend([face[0], face[k], face[k + 1]])
                    tri_tags.append(tag)
            elif directive is not None:
                tag = directive(t, tag)
    return vs, vts, vns, corners, tri_tags


def _split_vertices(vs, vts, vns, corners):
    """One vertex for each unique (v, vt, vn) corner, in first-use order:
    (positions, indices, normals or None, uvs)."""
    def resolve(idx, n):
        return idx - 1 if idx > 0 else n + idx

    key_to_new = {}
    positions, normals, uvs, indices = [], [], [], []
    for c in corners:
        if c not in key_to_new:
            key_to_new[c] = len(positions)
            vi, vti, vni = c
            positions.append(vs[resolve(vi, len(vs))])
            uvs.append(vts[resolve(vti, len(vts))] if vti else [0.0, 0.0])
            normals.append(vns[resolve(vni, len(vns))] if vni else None)
        indices.append(key_to_new[c])
    has_normals = all(n is not None for n in normals)
    return (np.asarray(positions, np.float32),
            np.asarray(indices, np.int32).reshape(-1, 3),
            np.asarray(normals, np.float32) if has_normals else None,
            np.asarray(uvs, np.float32))


def _load_obj_python(path):
    vs, vts, vns, corners, _ = _parse_obj(path)
    return _split_vertices(vs, vts, vns, corners)


def load_mtl(path):
    """{name: material dict} of a Wavefront .mtl file, for
    ``MaterialTable.build``:

    - Kd -> albedo_rgb; a nonzero Ke -> emission_rgb (emission_scale 1);
    - illum 4/6/7/9 or d < 1 -> dielectric with eta from Ni (Tf alone is a
      filter colour, not a sign of transparency);
    - Ks dominant with Ns -> rough_conductor, roughness sqrt(2/(Ns+2));
    - map_Kd -> texture_path, use_texture True.
    """
    mats = {}
    cur = None
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            key = t[0]
            if key == "newmtl":
                cur = {"kind": "diffuse", "albedo_rgb": (0.5, 0.5, 0.5)}
                mats[t[1]] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur["albedo_rgb"] = tuple(float(x) for x in t[1:4])
            elif key == "Ks":
                cur["_ks"] = tuple(float(x) for x in t[1:4])
            elif key == "Ke":
                ke = tuple(float(x) for x in t[1:4])
                if max(ke) > 0:
                    cur["emission_rgb"] = ke
                    cur["emission_scale"] = 1.0
            elif key == "Ns":
                cur["_ns"] = float(t[1])
            elif key == "Ni":
                cur["eta"] = float(t[1])
            elif key == "d":
                cur["_d"] = float(t[1])
            elif key == "Tr":
                cur["_d"] = 1.0 - float(t[1])
            elif key == "Tf":
                cur["_tf"] = tuple(float(x) for x in t[1:4])
            elif key == "illum":
                cur["_illum"] = int(t[1])
            elif key == "map_Kd":
                cur["texture_path"] = t[-1]
                cur["use_texture"] = True
    for m in mats.values():
        m.pop("_tf", None)
        transmissive = (m.pop("_d", 1.0) < 0.999
                        or m.get("_illum", 2) in (4, 6, 7, 9))
        ks = m.pop("_ks", (0.0, 0.0, 0.0))
        ns = m.pop("_ns", 0.0)
        m.pop("_illum", None)
        if transmissive:
            m["kind"] = "dielectric"
            m.setdefault("eta", 1.5)
        elif max(ks) > 0.5 and max(m["albedo_rgb"]) < 0.25 and ns > 1.0:
            m["kind"] = "rough_conductor"
            m["roughness"] = float(min(1.0, (2.0 / (ns + 2.0)) ** 0.5))
    return mats


def load_obj_scene(path):
    """An OBJ with its .mtl bindings: (positions, indices, normals, uvs,
    tri_mat (F,) i32, materials), the materials in first-use order (index
    0 a default diffuse where faces come before any usemtl)."""
    mtl_defs, name_to_id, materials = {}, {}, []

    def mat_id(name):
        if name not in name_to_id:
            name_to_id[name] = len(materials)
            materials.append(mtl_defs.get(
                name, {"kind": "diffuse", "albedo_rgb": (0.5, 0.5, 0.5)}))
        return name_to_id[name]

    def directive(t, tag):
        if t is None:                      # a face before any usemtl
            return mat_id("__default__")
        if t[0] == "mtllib":
            mpath = os.path.join(os.path.dirname(os.path.abspath(path)),
                                 t[1])
            if os.path.exists(mpath):
                mtl_defs.update(load_mtl(mpath))
        elif t[0] == "usemtl":
            return mat_id(t[1])
        return tag

    vs, vts, vns, corners, tags = _parse_obj(path, directive)
    positions, indices, normals, uvs = _split_vertices(vs, vts, vns, corners)
    return (positions, indices, normals, uvs, np.asarray(tags, np.int32),
            materials)


def save_obj(path, positions, indices):
    """Write a minimal OBJ: ``v`` lines of ``str`` of each float32, ``f``
    lines of 1-based indices."""
    with open(path, "w") as f:
        for p in np.asarray(positions):
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in np.asarray(indices):
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


class MeshCache:
    """Named model cache: a file is parsed once per (name, transform,
    device) and kept as a ``MeshData``. ``.ply`` files go through
    ``ply_loader.load_ply``, every other file through ``load_obj``."""
    _cache = {}

    @classmethod
    def load(cls, name, path, transform=None, device="cuda"):
        from computational_ray_tracer_tpu_torch.ops.triangle import MeshData
        key = (name, id(transform), str(device))
        if key not in cls._cache:
            if str(path).lower().endswith(".ply"):
                from computational_ray_tracer_tpu_torch.utils.ply_loader \
                    import load_ply
                pos, idx, nrm, uv = load_ply(path)
            else:
                pos, idx, nrm, uv = load_obj(path)
            cls._cache[key] = MeshData.build(pos, idx, normals=nrm, uvs=uv,
                                             transform=transform,
                                             device=device)
        return cls._cache[key]

    @classmethod
    def clear(cls):
        cls._cache.clear()
