"""Counter-based stateless samplers, bit-exact with the JAX reference.

Counterpart of ``computational_ray_tracer_tpu/ops/rng.py``. Every draw is a
pure function of ``(seed, pixel, sample, dim)``. The reference computes in
``uint32``; torch's CPU backend has no ``>>`` or ``%`` for ``uint32``, so the
port carries each 32-bit word in an ``int64`` (or a Python ``int``) in
``[0, 2^32)`` and masks with ``& 0xFFFFFFFF`` after every operation that can
leave that range. Multiplies by 32-bit constants are split into two 16-bit
halves so no intermediate exceeds 2^49 (no signed-overflow reliance).

Pixel ids and sample indices enter through :func:`_u32`, which is the cast
at the boundary: ``torch.arange`` gives ``int64`` where the reference uses
``uint32``, and equal values hash identically.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gpubench.reference.crt.ops.spectra_data import DATA_DIR

MASK = 0xFFFFFFFF


def _u32(x):
    if isinstance(x, (int, np.integer)):
        return int(x) & MASK
    return x.to(torch.int64) & MASK


def _mul(x, c):
    """(x * c) mod 2^32 for a 32-bit word x and a constant c."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def mix_bits(x):
    """murmur3 fmix32 finalizer."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_u32(*args, h=0x9E3779B9):
    """Variadic deterministic hash of integer arrays -> 32-bit word. ``h``
    continues a hash over more words: ``hash_u32(a, b, c)`` equals
    ``hash_u32(c, h=hash_u32(a, b))``."""
    for a in args:
        h = mix_bits(h ^ _mul(_u32(a), 0x01000193))
    return h


def u32_to_float(bits):
    """32-bit word -> float32 in [0, 1) from its top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def independent_1d(seed, pixel, sample_idx, dim):
    return u32_to_float(hash_u32(seed, pixel, sample_idx, dim))


def permutation_element(i, n: int, p):
    """Random permutation of [0, n) evaluated at i, keyed by p (Kensler
    cycle walking over the next power of two).

    The walk is exactly (w + 1) - n masked steps, with no host read:
    ``scramble`` is a bijection on [0, w + 1), so the orbit of an i < n
    reaches a value < n within the (w + 1) - n values >= n, and the result
    is the reference's loop's bit for bit. For an i >= n whose cycle holds
    no value < n (the reference's loop does not end there) the result is
    (x + p) mod n of the last step's x."""
    p = _u32(p)
    w = max(n, 1) - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    # (x * c) & w depends only on x & w; below 2^31 the int64 product of a
    # w-masked x and a 32-bit constant does not overflow.
    mul = _mul if w >> 31 else (lambda x, c: x * c)
    keys = (p & w, (p >> 16) & w)

    def scramble(x):
        for c_mul, c_xor, s in ((0x9E3779B9 | 1, 0x85EBCA6B, 5),
                                (0xC2B2AE35 | 1, 0x27D4EB2F, 3),
                                (0x165667B1 | 1, 0x9E3779B9, 7)):
            x = mul(x, c_mul) & w
            x = x ^ (x >> s)
            x = x ^ keys[0]
            x = mul(x, c_xor | 1) & w
            x = x ^ keys[1]
            x = x ^ (x >> 2)
        return x & w

    x = scramble(_u32(i) & w)
    if n & (n - 1):
        for _ in range(w + 1 - n):
            if isinstance(x, torch.Tensor):
                x = torch.where(x >= n, scramble(x), x)
            elif x >= n:
                x = scramble(x)
    return ((x + p) & MASK) % n


# ---------------------------------------------------------------------------
# Stratified sampler
# ---------------------------------------------------------------------------


def stratified_1d(seed, pixel, sample_idx, dim, spp: int, jitter=True):
    """One of ``spp`` strata, chosen by a per-(pixel, dim) permutation of
    the sample index, jittered within the stratum (or at its centre)."""
    stratum = permutation_element(sample_idx, spp,
                                  hash_u32(pixel, dim, seed))
    stratum = stratum.to(torch.float32)
    if jitter:
        delta = independent_1d(seed, pixel, sample_idx, dim)
    else:
        delta = torch.full_like(stratum, 0.5)
    return (stratum + delta) / spp


def stratified_2d(seed, pixel, sample_idx, dim, xs: int, ys: int,
                  jitter=True):
    """A cell of the (xs, ys) grid, spp = xs * ys, jittered per axis."""
    spp = xs * ys
    stratum = permutation_element(sample_idx, spp,
                                  hash_u32(pixel, dim, seed))
    x = (stratum % xs).to(torch.float32)
    y = (stratum // xs).to(torch.float32)
    if jitter:
        dx = independent_1d(seed, pixel, sample_idx, dim)
        dy = independent_1d(seed, pixel, sample_idx, dim + 1)
    else:
        dx = dy = torch.full_like(x, 0.5)
    return torch.stack([(x + dx) / xs, (y + dy) / ys], dim=-1)


# ---------------------------------------------------------------------------
# Sobol' matrices: Joe-Kuo initials for dims 2..37, committed tail beyond
# ---------------------------------------------------------------------------

_JOE_KUO = [
    (1, 0, [1]), (2, 1, [1, 3]), (3, 1, [1, 3, 1]), (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]), (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]), (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]), (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]), (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]), (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]), (6, 19, [1, 1, 1, 15, 7, 5]),
    (6, 22, [1, 3, 1, 15, 13, 25]), (6, 25, [1, 1, 5, 5, 19, 61]),
    (7, 1, [1, 3, 7, 11, 23, 15, 103]), (7, 4, [1, 3, 7, 13, 13, 15, 69]),
    (7, 7, [1, 1, 3, 13, 7, 35, 63]), (7, 8, [1, 3, 5, 9, 1, 25, 53]),
    (7, 14, [1, 3, 1, 13, 9, 35, 107]), (7, 19, [1, 3, 1, 5, 27, 61, 31]),
    (7, 21, [1, 1, 5, 11, 19, 41, 61]), (7, 28, [1, 3, 5, 3, 3, 13, 69]),
    (7, 31, [1, 1, 7, 13, 1, 19, 1]), (7, 32, [1, 3, 7, 5, 13, 19, 59]),
    (7, 37, [1, 1, 3, 9, 25, 29, 41]), (7, 41, [1, 3, 5, 13, 23, 1, 55]),
    (7, 42, [1, 3, 7, 3, 13, 59, 17]), (7, 50, [1, 3, 1, 3, 5, 53, 69]),
    (7, 55, [1, 1, 5, 5, 23, 33, 13]), (7, 56, [1, 1, 7, 7, 1, 61, 123]),
    (7, 59, [1, 1, 7, 9, 13, 61, 49]), (7, 62, [1, 3, 3, 5, 3, 55, 33]),
]


def _load_tail_initials(first_dim, n_needed):
    """Committed CBC-searched initials for dims >= first_dim, read from
    ``ops/data/sobol_tail.npz`` (a copy of the reference's table)."""
    z = np.load(os.path.join(DATA_DIR, "sobol_tail.npz"))
    if int(z["first_dim"]) != first_dim:
        raise ValueError("sobol_tail.npz does not start at dim %d" % first_dim)
    n = min(n_needed, int(z["s"].shape[0]))
    return [(int(z["s"][i]), int(z["a"][i]),
             [int(v) for v in z["m"][i, :int(z["s"][i])]]) for i in range(n)]


def _sobol_matrices(n_dims=72, n_bits=32):
    """(n_dims, 32) direction-number matrices: van der Corput, the Joe-Kuo
    initials and the committed tail (which covers every dim here; the
    reference's fallback past it is left out)."""
    jk = list(_JOE_KUO)
    if n_dims - 1 > len(jk):
        jk.extend(_load_tail_initials(len(jk) + 2, n_dims - 1 - len(jk)))
    if n_dims - 1 > len(jk):
        raise ValueError(f"the Sobol' tail covers {len(jk) + 1} dims")
    V = np.zeros((n_dims, n_bits), dtype=np.uint32)
    for k in range(n_bits):
        V[0, k] = np.uint32(1) << (31 - k)
    for d in range(1, n_dims):
        s, a, m_init = jk[d - 1]
        m = list(m_init)
        for k in range(s, n_bits):
            mk = m[k - s] ^ (m[k - s] << s)
            for t in range(1, s):
                if (a >> (s - 1 - t)) & 1:
                    mk ^= m[k - t] << t
            m.append(mk)
        for k in range(n_bits):
            V[d, k] = np.uint32((m[k] << (31 - k)) & MASK)
    return V


SOBOL_MATRICES = _sobol_matrices()
N_SOBOL_DIMS = SOBOL_MATRICES.shape[0]
_SOBOL_T = {}


def _sobol_table(device):
    key = str(device)
    if key not in _SOBOL_T:
        _SOBOL_T[key] = torch.as_tensor(SOBOL_MATRICES.astype(np.int64),
                                        device=device)
    return _SOBOL_T[key]


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def sobol_sample_u32(index, dim):
    """Raw 32-bit Sobol' value of point ``index`` in dimension ``dim``."""
    device = _device_of(index, dim)
    index = _u32(index)
    if not isinstance(index, torch.Tensor):    # a fill, not a host copy
        index = torch.full((), index, dtype=torch.int64, device=device)
    cols = _sobol_table(device)[dim]                     # (..., 32)
    ks = torch.arange(32, dtype=torch.int64, device=device)
    v = cols * ((index[..., None] >> ks) & 1)
    for half in (16, 8, 4, 2, 1):
        v = v[..., :half] ^ v[..., half:2 * half]
    return v[..., 0]


def _reverse_bits32(x):
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK


def fast_owen_scramble(v, scramble_seed):
    """Burley's hash-based nested uniform (Owen) scramble."""
    v = _reverse_bits32(v)
    v = (v + _u32(scramble_seed)) & MASK
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        v = v ^ _mul(v, c)
    return _reverse_bits32(v)


def _shuffled_index(seed, pixel, sample_idx, dim, spp):
    idx = _u32(sample_idx)
    if spp is not None:
        idx = permutation_element(idx, spp,
                                  hash_u32(seed, pixel, dim, 0x55555555))
    return idx


def sobol_owen_1d(seed, pixel, sample_idx, dim, spp=None):
    """Owen-scrambled Sobol' draw, padded per pixel (each (pixel, dim) gets
    its own randomized sequence); ``spp`` shuffles the index per pixel."""
    idx = _shuffled_index(seed, pixel, sample_idx, dim, spp)
    v = sobol_sample_u32(idx, _u32(dim) % N_SOBOL_DIMS)
    return u32_to_float(fast_owen_scramble(v, hash_u32(seed, pixel, dim)))


def sobol_owen_2d(seed, pixel, sample_idx, dim, spp=None):
    """A 2D Sobol' point: both dims share one shuffled index."""
    idx = _shuffled_index(seed, pixel, sample_idx, dim, spp)
    v0 = fast_owen_scramble(sobol_sample_u32(idx, _u32(dim) % N_SOBOL_DIMS),
                            hash_u32(seed, pixel, dim))
    v1 = fast_owen_scramble(
        sobol_sample_u32(idx, _u32(dim + 1) % N_SOBOL_DIMS),
        hash_u32(seed, pixel, dim + 1))
    return torch.stack([u32_to_float(v0), u32_to_float(v1)], dim=-1)


