"""Stanford PLY import and export (``computational_ray_tracer_tpu/utils/
ply_loader.py``): ASCII and binary little/big endian; vertex x/y/z,
optional nx/ny/nz normals and u/v (or s/t) texcoords onto the (positions,
indices, normals, uvs) arrays ``MeshData.build`` takes; face lists
fan-triangulated; other elements and properties skipped.

``load_ply`` parses with the C++ loader (``csrc/host/ply_loader.cpp``, in
``build/libcrt_host.so``) unless ``native=False`` asks for the Python
parser, its plain version. There is no fallback: a failed build of the
host library raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from computational_ray_tracer_tpu_torch.kernels import build
from computational_ray_tracer_tpu_torch.utils.obj_loader import _mesh_arrays

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path, native=None):
    """(positions (V, 3) f32, indices (F, 3) i32, normals or None, uvs or
    None): normals and uvs are None where the file has no nx/ny/nz (u/v or
    s/t) properties. ``native`` None or True: the C++ loader; False: the
    Python parser. Both give equal arrays."""
    if native is False:
        return _load_ply_python(path)
    lib = build.load_host_library()
    m = build.CrtMesh()
    rc = lib.crt_load_ply(str(path).encode(), ctypes.byref(m))
    if rc != 0:
        raise ValueError(f"crt_load_ply({path}) failed rc={rc}")
    try:
        return _mesh_arrays(m, bool(m.has_uvs and m.n_verts))
    finally:
        lib.crt_free_mesh(ctypes.byref(m))


def _load_ply_python(path):
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop name, dtype or list spec)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            t = line.decode("ascii", "replace").split()
            if not t or t[0] == "comment":
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                elements.append((t[1], int(t[2]), []))
            elif t[0] == "property":
                if t[1] == "list":
                    elements[-1][2].append(
                        (t[4], ("list", _PLY_TYPES[t[2]], _PLY_TYPES[t[3]])))
                else:
                    elements[-1][2].append((t[2], _PLY_TYPES[t[1]]))
            elif t[0] == "end_header":
                break
        if fmt == "ascii":
            data = _read_ascii(f, elements)
        elif fmt in ("binary_little_endian", "binary_big_endian"):
            data = _read_binary(f, elements,
                                "<" if fmt == "binary_little_endian" else ">")
        else:
            raise ValueError(f"{path}: unknown PLY format {fmt!r}")

    vert = data.get("vertex")
    if vert is None:
        raise ValueError(f"{path}: no vertex element")
    cols = lambda *ks: np.stack([vert[k] for k in ks],
                                axis=1).astype(np.float32)
    positions = cols("x", "y", "z")
    normals = cols("nx", "ny", "nz") if all(
        k in vert for k in ("nx", "ny", "nz")) else None
    uvs = None
    for ku, kv in (("u", "v"), ("s", "t")):
        if ku in vert and kv in vert:
            uvs = cols(ku, kv)
            break
    face = data.get("face", {})
    polys = next((face[k] for k in ("vertex_indices", "vertex_index")
                  if k in face), None)
    return positions, _fan(polys), normals, uvs


def _fan(polys):
    """Fan triangulation, polygon by polygon: (F, 3) int32. ``polys`` is a
    (rows, n) array (every polygon of n corners) or a list of arrays."""
    if polys is None:
        return np.zeros((0, 3), np.int32)
    if isinstance(polys, np.ndarray):
        n = polys.shape[1]
        if n < 3:
            return np.zeros((0, 3), np.int32)
        tris = np.stack([np.repeat(polys[:, :1], n - 2, axis=1),
                         polys[:, 1:n - 1], polys[:, 2:]], axis=-1)
        return tris.reshape(-1, 3).astype(np.int32)
    tris = []
    for poly in polys:
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
    return (np.asarray(tris, np.int32).reshape(-1, 3) if tris
            else np.zeros((0, 3), np.int32))


def _read_ascii(f, elements):
    out = {}
    lines = [ln.split() for ln in f.read().decode("ascii", "replace")
             .split("\n") if ln.strip()]
    row = 0
    for name, count, props in elements:
        cols = {p: [] for p, _ in props}
        for _ in range(count):
            t = lines[row]
            row += 1
            pos = 0
            for pname, spec in props:
                if isinstance(spec, tuple):  # list property
                    n = int(t[pos])
                    cols[pname].append(np.asarray(
                        [float(x) for x in t[pos + 1:pos + 1 + n]]))
                    pos += 1 + n
                else:
                    cols[pname].append(float(t[pos]))
                    pos += 1
        out[name] = {p: (v if isinstance(v[0], np.ndarray)
                         else np.asarray(v))
                     for p, v in cols.items()} if count else {}
    return out


def _uniform_rows(buf, off, count, props, endian):
    """The rows of an element with list properties read as one structured
    array, if every row's lists have the first row's lengths (a list is
    then a (count, n) array): (columns, end offset), or None."""
    fields, pos = [], off
    for pname, spec in props:
        if isinstance(spec, tuple):
            cdt = np.dtype(endian + spec[1])
            if pos + cdt.itemsize > len(buf):
                return None
            n = int(np.frombuffer(buf, cdt, 1, pos)[0])
            if n == 0:
                return None
            fields += [(pname + "/n", cdt), (pname, endian + spec[2], (n,))]
            pos += cdt.itemsize + np.dtype(endian + spec[2]).itemsize * n
        else:
            fields.append((pname, endian + spec))
            pos += np.dtype(endian + spec).itemsize
    dt = np.dtype(fields)
    if off + dt.itemsize * count > len(buf):
        return None
    arr = np.frombuffer(buf, dtype=dt, count=count, offset=off)
    for pname, spec in props:
        if isinstance(spec, tuple) and not (
                arr[pname + "/n"] == dt[pname].shape[0]).all():
            return None
    return ({p: np.ascontiguousarray(arr[p]) for p, _ in props},
            off + dt.itemsize * count)


def _read_binary(f, elements, endian):
    out = {}
    buf = f.read()
    off = 0
    for name, count, props in elements:
        fixed = all(not isinstance(s, tuple) for _, s in props)
        if fixed and count:
            dt = np.dtype([(p, endian + s) for p, s in props])
            arr = np.frombuffer(buf, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            out[name] = {p: np.ascontiguousarray(arr[p]) for p, _ in props}
            continue
        uniform = _uniform_rows(buf, off, count, props, endian) \
            if count else None
        if uniform is not None:
            out[name], off = uniform
            continue
        cols = {p: [] for p, _ in props}
        for _ in range(count):
            for pname, spec in props:
                if isinstance(spec, tuple):
                    _, cnt_t, val_t = spec
                    cdt = np.dtype(endian + cnt_t)
                    n = int(np.frombuffer(buf, cdt, 1, off)[0])
                    off += cdt.itemsize
                    vdt = np.dtype(endian + val_t)
                    cols[pname].append(np.frombuffer(buf, vdt, n, off))
                    off += vdt.itemsize * n
                else:
                    vdt = np.dtype(endian + spec)
                    cols[pname].append(np.frombuffer(buf, vdt, 1, off)[0])
                    off += vdt.itemsize
        out[name] = {p: (v if v and isinstance(v[0], np.ndarray)
                         else np.asarray(v))
                     for p, v in cols.items()} if count else {}
    return out


def save_ply(path, positions, indices, normals=None, uvs=None, binary=True):
    """Write a PLY file: float32 vertex properties (x/y/z, then nx/ny/nz
    and u/v where given), triangles as uchar-counted int lists; binary
    little endian or ASCII (``repr`` of each float)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    props = ["property float x", "property float y", "property float z"]
    cols = [positions]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    if uvs is not None:
        props += ["property float u", "property float v"]
        cols.append(np.asarray(uvs, np.float32))
    header = "\n".join(
        ["ply",
         "format binary_little_endian 1.0" if binary else "format ascii 1.0",
         f"element vertex {len(positions)}"] + props +
        [f"element face {len(indices)}",
         "property list uchar int vertex_indices",
         "end_header", ""])
    vdata = np.concatenate(cols, axis=1)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(vdata, "<f4").tobytes())
            face = np.empty((len(indices),),
                            np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
            face["n"] = 3
            face["v"] = indices
            f.write(face.tobytes())
        else:
            for row in vdata:
                f.write((" ".join(repr(float(x)) for x in row) + "\n")
                        .encode("ascii"))
            for tri in indices:
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode("ascii"))
