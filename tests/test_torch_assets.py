"""The port's asset layer against the JAX package's on the same inputs: the
OBJ/MTL and PLY loaders (the C++ loaders in ``csrc/host/`` and the Python
parsers) and writers, ``mesh_gen.box``, the asset cache, ``MeshCache``,
and the PNG codec (held against PIL both ways). Loaders and writers are
held to exact equality."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from test_assets import MTL, OBJ
from test_native_mesh import (OBJ_FULL, OBJ_MIXED, OBJ_POS_ONLY,
                              _ply_fixture_arrays)
from computational_ray_tracer_tpu.ops import triangle as jtri
from computational_ray_tracer_tpu.utils import image as jimage
from computational_ray_tracer_tpu.utils import mesh_gen as jmesh_gen
from computational_ray_tracer_tpu.utils import obj_loader as jobj
from computational_ray_tracer_tpu.utils import ply_loader as jply
from computational_ray_tracer_tpu_torch.ops import shapes as tshp
from computational_ray_tracer_tpu_torch.ops import triangle as ttri
from computational_ray_tracer_tpu_torch.utils import asset_cache
from computational_ray_tracer_tpu_torch.utils import image as timage
from computational_ray_tracer_tpu_torch.utils import mesh_gen as tmesh_gen
from computational_ray_tracer_tpu_torch.utils import obj_loader as tobj
from computational_ray_tracer_tpu_torch.utils import ply_loader as tply

CANONICAL_PNG = "benchmarks/data/canonical_500.png"


def assert_same(got, want):
    """Tuples of arrays (or None) equal in dtype, shape and every value."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g is None or w is None:
            assert g is None and w is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("src", [OBJ_FULL, OBJ_POS_ONLY, OBJ_MIXED],
                         ids=["full", "pos-only", "mixed"])
def test_load_obj_matches_reference(tmp_path, src, native):
    """Quads and triangles, negative indices, missing vt/vn: the same
    vertex split and the same arrays as the reference's Python parser."""
    p = tmp_path / "m.obj"
    p.write_text(src)
    assert_same(tobj.load_obj(p, native=native),
                jobj.load_obj(p, native=False))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_save_obj_and_large_mesh_match_reference(tmp_path, native):
    """save_obj writes the reference's bytes; a seeded 2,000-triangle mesh
    loads to the reference's arrays, and to the written triangles."""
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(500, 3)).astype(np.float32)
    idx = rng.integers(0, 500, size=(2000, 3)).astype(np.int32)
    tobj.save_obj(tmp_path / "t.obj", pos, idx)
    jobj.save_obj(tmp_path / "j.obj", pos, idx)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    got = tobj.load_obj(tmp_path / "t.obj", native=native)
    assert_same(got, jobj.load_obj(tmp_path / "j.obj", native=False))
    np.testing.assert_array_equal(got[0][got[1]], pos[idx])
    assert got[2] is None


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_load_obj_missing_file_raises(native):
    with pytest.raises(FileNotFoundError):
        tobj.load_obj("/nonexistent/nope.obj", native=native)


def test_load_mtl_matches_reference(tmp_path):
    p = tmp_path / "scene.mtl"
    p.write_text(MTL)
    assert tobj.load_mtl(p) == jobj.load_mtl(p)


@pytest.mark.parametrize("case", ["mtl", "no_usemtl"])
def test_load_obj_scene_matches_reference(tmp_path, case):
    """Per-face materials from usemtl runs (a default diffuse where faces
    come first), the MTL bindings and the geometry, as the reference's."""
    if case == "mtl":
        (tmp_path / "scene.mtl").write_text(MTL)
        src = OBJ
    else:
        src = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3\n"
    p = tmp_path / "scene.obj"
    p.write_text(src)
    got, want = tobj.load_obj_scene(p), jobj.load_obj_scene(p)
    assert_same(got[:5], want[:5])
    assert got[5] == want[5]
    assert_same(got[:4], tobj.load_obj(p))


PLY_CASES = [(b, a) for b in (False, True) for a in (False, True)]


@pytest.mark.parametrize("binary,with_attrs", PLY_CASES,
                         ids=[f"{'binary' if b else 'ascii'}-"
                              f"{'attrs' if a else 'plain'}"
                              for b, a in PLY_CASES])
def test_save_ply_matches_reference(tmp_path, binary, with_attrs):
    pos, idx, nrm, uv = _ply_fixture_arrays()
    attrs = (nrm, uv) if with_attrs else (None, None)
    tply.save_ply(tmp_path / "t.ply", pos, idx, *attrs, binary=binary)
    jply.save_ply(tmp_path / "j.ply", pos, idx, *attrs, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("binary,with_attrs", PLY_CASES,
                         ids=[f"{'binary' if b else 'ascii'}-"
                              f"{'attrs' if a else 'plain'}"
                              for b, a in PLY_CASES])
def test_load_ply_matches_reference(tmp_path, binary, with_attrs, native):
    pos, idx, nrm, uv = _ply_fixture_arrays()
    p = tmp_path / "m.ply"
    jply.save_ply(p, pos, idx, normals=nrm if with_attrs else None,
                  uvs=uv if with_attrs else None, binary=binary)
    assert_same(tply.load_ply(p, native=native),
                jply.load_ply(p, native=False))


def _big_endian_ply(path, faces):
    """The reference test's hand-built big-endian file: double positions,
    a skipped uchar property, s/t texcoords, an element to skip, and the
    ``faces`` polygons."""
    header = (
        b"ply\nformat binary_big_endian 1.0\n"
        b"comment hand-built\n"
        b"element vertex 5\n"
        b"property double x\nproperty double y\nproperty double z\n"
        b"property uchar red\n"
        b"property float s\nproperty float t\n"
        b"element junk 2\n"
        b"property short a\nproperty list uchar int b\n"
        + f"element face {len(faces)}\n".encode() +
        b"property list uchar int vertex_indices\n"
        b"end_header\n")
    body = b""
    verts = [(0, 0, 0, 10, 0.1, 0.2), (1, 0, 0, 20, 0.3, 0.4),
             (1, 1, 0, 30, 0.5, 0.6), (0, 1, 0, 40, 0.7, 0.8),
             (0.5, 0.5, 1, 50, 0.9, 1.0)]
    for (x, y, z, r, s_, t_) in verts:
        body += struct.pack(">dddBff", x, y, z, r, s_, t_)
    body += struct.pack(">hBii", 7, 2, 1, 2)
    body += struct.pack(">hBi", 9, 1, 3)
    for poly in faces:
        body += struct.pack(f">B{len(poly)}i", len(poly), *poly)
    path.write_bytes(header + body)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("faces", [[(0, 1, 2, 3)], [(0, 1, 2, 3), (1, 4, 2)],
                                   [(0, 1, 4), (1, 2, 4), (2, 3, 4)]],
                         ids=["quad", "quad-and-triangle", "triangles"])
def test_load_ply_big_endian_and_polygons(tmp_path, faces, native):
    """Big endian, mixed property types, a skipped element, fan-
    triangulated polygons of one or of mixed sizes: the reference's
    arrays."""
    p = tmp_path / "be.ply"
    _big_endian_ply(p, faces)
    got = tply.load_ply(p, native=native)
    assert_same(got, jply.load_ply(p, native=False))
    assert got[2] is None and got[3].shape == (5, 2)
    assert got[1].shape == (sum(len(f) - 2 for f in faces), 3)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_load_ply_missing_file_raises(native):
    with pytest.raises((FileNotFoundError, ValueError)):
        tply.load_ply("/nonexistent/nope.ply", native=native)


@pytest.mark.parametrize("flip", [False, True])
def test_box_matches_reference(flip):
    lo, hi = (-1.0, -2.0, 0.25), (1.5, 0.5, 3.0)
    assert_same(tmesh_gen.box(lo, hi, flip), jmesh_gen.box(lo, hi, flip))


@pytest.mark.parametrize("name,args", [
    ("displaced_icosphere", (3,)), ("dragon_stand_in", (6000,))])
def test_cached_generation_is_bitwise_uncached(tmp_path, monkeypatch, name,
                                               args):
    """The first call generates the mesh and stores it under the port's
    prefix; the second reads it back: bitwise equal to the first and to the
    reference's generator, without writing again."""
    monkeypatch.setattr(asset_cache, "_CACHE_DIR", str(tmp_path))
    gen = getattr(tmesh_gen, name)
    generated = gen(*args)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith(asset_cache.PREFIX)
    monkeypatch.setattr(asset_cache, "store",
                        lambda *a, **k: pytest.fail("cached mesh rewritten"))
    assert_same(gen(*args), generated)
    assert_same(generated, getattr(jmesh_gen, name)(*args))


def _mesh_fields(m):
    return [np.asarray(getattr(m, k)) for k in
            ("positions", "normals", "uvs", "tangents", "bitangents")]


@pytest.mark.parametrize("fmt,transform", [
    ("obj", None), ("ply", None),
    ("ply", ((0.1, -0.2, 0.3), (10, 20, 30), 1.5))],
    ids=["obj", "ply", "ply-transform"])
def test_mesh_cache_matches_reference(tmp_path, fmt, transform):
    """MeshCache.load builds the MeshData the reference's builds, once per
    name; a transform moves positions and normals alike."""
    pos, idx, nrm, uv = _ply_fixture_arrays()
    p = tmp_path / f"m.{fmt}"
    if fmt == "obj":
        jobj.save_obj(p, pos, idx)
    else:
        jply.save_ply(p, pos, idx, normals=nrm, uvs=uv)
    tf = None if transform is None else tshp.make_transform(*transform)
    tobj.MeshCache.clear()
    jobj.MeshCache.clear()
    got = tobj.MeshCache.load("m", p, transform=tf, device="cpu")
    assert tobj.MeshCache.load("m", p, transform=tf, device="cpu") is got
    want = jobj.MeshCache.load("m", p, transform=tf)
    tobj.MeshCache.clear()
    jobj.MeshCache.clear()
    for g, w in zip(_mesh_fields(got), _mesh_fields(want)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_mesh_data_transform_matches_reference():
    pos, idx, nrm, uv = _ply_fixture_arrays()
    tf = tshp.make_transform((1, 2, 3), (0, 45, 90), 0.5)
    for normals in (None, nrm):
        got = ttri.MeshData.build(pos, idx, normals=normals, uvs=uv,
                                  transform=tf)
        want = jtri.MeshData.build(pos, idx, normals=normals, uvs=uv,
                                   transform=tf)
        for g, w in zip(_mesh_fields(got), _mesh_fields(want)):
            np.testing.assert_array_equal(g, w)


# --- PNG --------------------------------------------------------------------

def _seeded_image(h=13, w=17, seed=0):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, (h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["float", "uint8", "tensor"])
def test_write_png_decodes_in_pil(tmp_path, kind):
    """PIL decodes the port's file to exactly to_uint8(img) (out-of-range
    floats clipped), as the reference's writer does."""
    img = _seeded_image()
    arg = {"float": img, "uint8": jimage.to_uint8(img),
           "tensor": torch.as_tensor(img)}[kind]
    timage.write_png(tmp_path / "t.png", arg)
    jimage.write_png(tmp_path / "j.png", img)
    got = np.asarray(Image.open(tmp_path / "t.png"))
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, timage.to_uint8(img))
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j.png")))


def test_read_image_matches_reference_on_a_pil_file():
    """The committed 500x500 RGB PNG that PIL wrote (its own row filters,
    IDAT over several chunks) decodes to the reference's read_image."""
    got = timage.read_image(CANONICAL_PNG)
    want = jimage.read_image(CANONICAL_PNG)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(arr, filters):
    """An 8-bit PNG of ``arr`` (H, W, C) with row y filtered by
    ``filters[y % len(filters)]``, its IDAT split in three chunks."""
    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int64)
    prior = np.zeros(w * c, np.int64)
    rows = b""
    for y in range(h):
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        pred = [0, left, prior, (left + prior) // 2,
                _paeth(left, prior, up_left)][ft]
        rows += bytes([ft]) + ((x[y] - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = x[y]
    data = zlib.compress(rows)
    cut = [0, len(data) // 3, 2 * len(data) // 3, len(data)]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[a:b])
                       for a, b in zip(cut[:-1], cut[1:]))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_read_png_row_filters_match_pil(tmp_path, filters, channels):
    """Each of the five row filters (and all of them row by row) in gray,
    RGB and RGBA: decoded to the source bytes, and read_image equal to
    PIL's RGB conversion of the same file."""
    arr = np.random.default_rng(len(filters) * 7 + channels).integers(
        0, 256, (11, 9, channels)).astype(np.uint8)
    data = _filtered_png(arr, filters)
    np.testing.assert_array_equal(timage.decode_png(data), arr)
    p = tmp_path / "f.png"
    p.write_bytes(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(timage.read_image(p),
                                  pil.astype(np.float32) / 255.0)


def _header_png(depth, ctype, interlace):
    body = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
    chunk = (struct.pack(">I", len(body)) + b"IHDR" + body
             + struct.pack(">I", zlib.crc32(b"IHDR" + body)))
    return b"\x89PNG\r\n\x1a\n" + chunk + (
        struct.pack(">I", 0) + b"IEND" + struct.pack(">I", zlib.crc32(b"IEND")))


@pytest.mark.parametrize("depth,ctype,interlace", [
    (16, 2, 0), (8, 3, 0), (8, 4, 0), (8, 2, 1)],
    ids=["16-bit", "palette", "gray-alpha", "interlaced"])
def test_read_png_refuses_other_formats(depth, ctype, interlace):
    with pytest.raises(ValueError, match="unsupported PNG"):
        timage.decode_png(_header_png(depth, ctype, interlace))


@pytest.mark.parametrize("fault", ["crc", "signature", "no_iend"])
def test_read_png_refuses_damaged_files(fault):
    data = bytearray(_filtered_png(np.zeros((2, 2, 3), np.uint8), (0,)))
    if fault == "crc":
        data[-20] ^= 1
    elif fault == "signature":
        data[1] = ord("Q")
    else:
        data = data[:-12]
    with pytest.raises(ValueError):
        timage.decode_png(bytes(data))


def test_write_npy_roundtrip(tmp_path):
    img = torch.as_tensor(_seeded_image())
    timage.write_npy(tmp_path / "i.npy", img)
    np.testing.assert_array_equal(np.load(tmp_path / "i.npy"), img.numpy())
