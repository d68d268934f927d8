"""The numbers that decide ``correct``, each against its limit."""

from __future__ import annotations

import statistics

import torch

# The stream of draws from --seed that picks what is checked, apart from
# the frames' and jobs' own streams (k >= 0).
CHECK_STREAM = 1 << 40


def rel_l1(got, ref):
    """sum |got - ref| / sum |ref| over every element (float64)."""
    got = torch.as_tensor(got).double().cpu()
    ref = torch.as_tensor(ref).double().cpu()
    return float((got - ref).abs().sum() / ref.abs().sum().clamp_min(1e-300))


def leaf_norm_gaps(got, ref, gate):
    """The worst leaf's gap of norms, |‖got‖ - ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖, over the leaves (dict keys) whose
    ``gate`` norm is at least a thousandth of the median leaf's (leaves
    whose reference gradient is nought to rounding move by round-off
    alone)."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double().cpu()))
    gate_n = {k: norm(v) for k, v in gate.items()}
    g_med = statistics.median(gate_n.values())
    keep = [k for k in ref if gate_n[k] >= 1e-3 * g_med]
    ref_n = {k: norm(ref[k]) for k in keep}
    r_med = statistics.median(ref_n.values())
    return max(abs(norm(got[k]) - ref_n[k]) / max(ref_n[k], r_med, 1e-300)
               for k in keep)


def judge(values, limits):
    """(correct, {name: {"value", "limit"}}): every limit's number present
    and at most its limit."""
    checks = {name: {"value": values.get(name), "limit": limit}
              for name, limit in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
