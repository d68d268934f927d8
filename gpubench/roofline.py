"""Peaks of one H100 and the least time of a kernel's work, counted from
the benchmark's own frozen plain algorithms, never from the kernel's own
counters (a rewritten kernel would move the yardstick).

Published peaks of the H100 SXM at 700 W (NVIDIA's data sheet): 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM."""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# fp32 operations of one watertight ray/triangle test up to its edge-sign
# verdict (every test needs them) and of one ray/box slab test.
TRIANGLE_TEST_FLOPS = 108
SLAB_TEST_FLOPS = 23
# Floats read for one node's bounds slot and one triangle's slot.
NODE_FLOATS = 16
TRIANGLE_FLOATS = 16


def least_seconds(flops, nbytes):
    """(seconds, "ops" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def octree_closest_bound(n_rays, live, tests, pops, table_bytes,
                         out_words=4):
    """The least time of one closest-hit traversal launch over ``n_rays``
    rays (``live`` with t_max > 0), from the plain traversal's triangle
    tests and node pops (one slab test each): the operations of every test;
    t_max read and ``out_words`` words written for every ray, o and d read
    for the live ones, and the tree's tables once or, where less, one node
    slot per pop and one triangle slot per test."""
    flops = tests * TRIANGLE_TEST_FLOPS + pops * SLAB_TEST_FLOPS
    touched = 4 * (pops * NODE_FLOATS + tests * TRIANGLE_FLOATS)
    nbytes = 4 * n_rays * (1 + out_words) + 24 * live + min(table_bytes,
                                                            touched)
    return least_seconds(flops, nbytes)
