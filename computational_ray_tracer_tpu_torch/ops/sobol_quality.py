"""Digital-net quality of Sobol' direction numbers, on the host
(``computational_ray_tracer_tpu/ops/sobol_quality.py``, which is NumPy and
pure Python; this is its copy, so the port stands without the reference).

The exact (t, m, 2)-net t-value of any 2D projection of the generator
matrices, computed over GF(2) (the quantity Joe and Kuo's D(6) search
minimizes), the square-bin balance defect, and the deterministic
component-by-component search that picked the initial direction numbers
of the committed tail (``ops/data/sobol_tail.npz``, dims 38 and up) by
minimizing their worst and total 2D t-values against every earlier
dimension. The renderer only loads the committed result.
"""

from __future__ import annotations

import numpy as np


def expand_direction_numbers(s, a, m_init, n_bits=32):
    """Direction numbers v_k = m_k << (n_bits-1-k) from the recurrence
    m_k = m_{k-s} ^ (m_{k-s} << s) ^ XOR_{t: a_t=1} (m_{k-t} << t)
    (the standard Sobol construction; samplers.h:144-327 capability)."""
    m = list(m_init)
    assert len(m) == s
    for k in range(s, n_bits):
        mk = m[k - s] ^ (m[k - s] << s)
        for t in range(1, s):
            if (a >> (s - 1 - t)) & 1:
                mk ^= m[k - t] << t
        m.append(mk)
    return [(m[k] << (n_bits - 1 - k)) & 0xFFFFFFFF for k in range(n_bits)]


def vdc_direction_numbers(n_bits=32):
    """Dimension 0: the van der Corput identity matrix."""
    return [1 << (n_bits - 1 - k) for k in range(n_bits)]


def row_masks(v32, mb, n_bits=32):
    """Generator-matrix rows for an mb-bit analysis: row r (r-th output
    bit, MSB first) as an integer mask over the mb input index bits."""
    rows = []
    for r in range(mb):
        mask = 0
        for k in range(mb):
            mask |= ((v32[k] >> (n_bits - 1 - r)) & 1) << k
        rows.append(mask)
    return rows


def gf2_rank(vecs):
    """Rank over GF(2) of integer-bitmask row vectors."""
    pivots = {}
    rank = 0
    for v in vecs:
        while v:
            h = v.bit_length() - 1
            if h in pivots:
                v ^= pivots[h]
            else:
                pivots[h] = v
                rank += 1
                break
    return rank


def pair_t_value(rows1, rows2, mb):
    """Exact t-value of the 2D projection: the net is a (t, mb, 2)-net in
    base 2 with t = mb - k*, where k* is the largest k such that for EVERY
    split d1 + d2 = k the first d1 rows of C1 together with the first d2
    rows of C2 are linearly independent. The predicate is monotone in k
    (subsets of independent sets are independent), so binary search."""

    def ok(k):
        for d1 in range(max(0, k - mb), min(k, mb) + 1):
            d2 = k - d1
            if gf2_rank(rows1[:d1] + rows2[:d2]) < k:
                return False
        return True

    lo, hi = 0, mb
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid - 1
    return mb - lo


def dim1_t_value(rows, mb):
    """1D t-value: 0 iff the matrix is nonsingular (every Sobol dim with
    odd initial values is a (0,1)-sequence — sanity check)."""
    return mb - gf2_rank(rows[:mb])


def diag_deficiency(rows1, rows2, mb, max_j=None):
    """Square-bin balance defect: for j = 1..max_j, the rank deficiency of
    the first j rows of BOTH matrices stacked (2j rows). Deficiency 0 at
    level j means every 2^j x 2^j bin grid over the 2^mb points is exactly
    equidistributed — the condition square-bin chi-square tests measure,
    which the aggregate t-value alone does not pin down (t bounds the
    worst SPLIT, but a chi-square at 16x16 bins cares about the (j,j)
    split specifically)."""
    if max_j is None:
        max_j = mb // 2
    worst = 0
    for j in range(1, max_j + 1):
        worst = max(worst, 2 * j - gf2_rank(rows1[:j] + rows2[:j]))
    return worst


def cbc_search_dim(prev_rows, s, a, mb=12, n_candidates=64, seed=0,
                   rng=None):
    """Pick initial direction numbers for one new dimension with primitive
    polynomial (s, a): deterministic random search over valid odd
    m-vectors, scored lexicographically by (max diagonal deficiency,
    max 2D t-value, sum of both) against every previous dimension — the
    CBC form of the Joe-Kuo criterion plus explicit square-bin balance.

    Returns (m_init, max_t, sum_t, max_diag)."""
    if rng is None:
        rng = np.random.Generator(np.random.PCG64(seed))
    best = None
    for _ in range(n_candidates):
        m_init = [int(rng.integers(0, 1 << max(i - 1, 0))) * 2 + 1
                  for i in range(1, s + 1)]
        v = expand_direction_numbers(s, a, m_init)
        rows = row_masks(v, mb)
        if dim1_t_value(rows, mb) != 0:
            continue
        ts = [pair_t_value(p, rows, mb) for p in prev_rows]
        # Square-bin balance only through j=4 (exact 16x16-bin
        # equidistribution vs every earlier dim): a j<=6 constraint forces
        # bad t tradeoffs (measured: one dim regressed to t=10), while
        # j<=4 is satisfiable together with t<=6 everywhere.
        ds = [diag_deficiency(p, rows, mb, max_j=4) for p in prev_rows]
        score = (max(ds), max(ts), sum(ts) + sum(ds))
        if best is None or score < best[1]:
            best = (m_init, score)
    m_init, (max_diag, max_t, total) = best
    return m_init, max_t, total, max_diag
