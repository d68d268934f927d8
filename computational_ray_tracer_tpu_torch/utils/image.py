"""Headless image I/O (``computational_ray_tracer_tpu/utils/image.py``):
PNG and .npy dumps of rendered images, and the image reader texture scenes
use.

The PNG codec is written here with the standard library (``zlib``,
``struct``, ``binascii.crc32``), so the port needs no imaging package. The
writer stores 8-bit RGB rows with filter 0 (None). The reader takes 8-bit
grayscale, RGB and RGBA files, not interlaced, with any of the five row
filters; any other PNG raises ``ValueError``.
"""

from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}      # colour type -> samples a pixel


def _numpy(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img):
    return (np.clip(_numpy(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", binascii.crc32(body) & 0xFFFFFFFF))


def encode_png(img):
    """The bytes of an 8-bit RGB PNG of ``img``: (H, W, 3) float in [0, 1]
    or uint8."""
    arr = _numpy(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, not {arr.shape}")
    h, w, _ = arr.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)    # filter byte 0 a row
    rows[:, 1:] = arr.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img):
    """img: (H, W, 3) float in [0,1] or uint8."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _chunks(data):
    """(type, payload) of each chunk, its CRC checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != binascii.crc32(kind + body) \
                & 0xFFFFFFFF:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file without IEND")


def _unfilter_avg(f, prior, bpp):
    out = bytearray(f)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter_paeth(f, prior, bpp):
    out = bytearray(f)
    for i in range(bpp):
        out[i] = (out[i] + prior[i]) & 0xFF
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], prior[i], prior[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def decode_png(data):
    """(H, W, C) uint8 of an 8-bit grayscale (C = 1), RGB (3) or RGBA (4)
    PNG, not interlaced."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit gray/RGB/"
                         "RGBA, not interlaced, only)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + stride):
        raise ValueError(f"PNG data holds {len(raw)} bytes, not "
                         f"{h * (1 + stride)}")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (1 + stride)]
        f = np.frombuffer(raw, np.uint8, stride, y * (1 + stride) + 1)
        if ftype == 0:
            row = f
        elif ftype == 1:        # Sub: a running sum of each channel
            row = (np.cumsum(f.reshape(w, bpp), axis=0, dtype=np.int64)
                   & 0xFF).astype(np.uint8).reshape(stride)
        elif ftype == 2:        # Up
            row = f + prior
        elif ftype == 3:        # Average
            row = np.frombuffer(_unfilter_avg(f.tobytes(), prior.tobytes(),
                                              bpp), np.uint8)
        elif ftype == 4:        # Paeth
            row = np.frombuffer(_unfilter_paeth(f.tobytes(), prior.tobytes(),
                                                bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = row
        prior = out[y]
    return out.reshape(h, w, bpp)


def read_image(path):
    """(H, W, 3) float32 in [0,1] of a PNG: gray repeated to RGB, the alpha
    of RGBA dropped."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0


def write_npy(path, img):
    np.save(path, _numpy(img))
