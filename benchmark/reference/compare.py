"""The numbers that decide `correct`, each a gap between the program's
reading and the reference's, taken leaf by leaf where it is of a tree.

A leaf's gap is the difference of the two norms (not the norm of the
difference: the program's atomic sums and the reference's gathers round in
another order), over the reference's norm of that leaf or of the median
leaf, whichever is larger, so that a leaf whose reading is all but zero
does not blow up. Leaves whose first gradient in the reference is under a
thousandth of the median leaf's move under Adam by round-off alone; they
are left out of the change by that rule (`moving`).
"""

from __future__ import annotations

import math

import torch


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def worst_leaf(prog: dict, ref: dict, keys=None) -> float:
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    keys = list(ref) if keys is None else list(keys)
    if not keys:
        return 0.0
    rn = {k: _norm(ref[k]) for k in keys}
    med = sorted(rn.values())[len(rn) // 2]
    worst = 0.0
    for k in keys:
        den = max(rn[k], med)
        gap = abs(_norm(prog[k]) - rn[k]) / den if den > 0 else 0.0
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def moving(grads: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = {k: _norm(v) for k, v in grads.items()}
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= 1e-3 * med]


def loss_gap(prog: list, ref: list) -> float:
    """The largest relative gap of the steps' losses."""
    out = 0.0
    for p, r in zip(prog, ref):
        p, r = float(p), float(r)
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        out = max(out, abs(p - r) / max(abs(r), 1e-30))
    return out


def widest_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| over max |ref| (rows in the same order)."""
    if prog.shape != ref.shape:
        return math.inf
    if prog.numel() == 0:
        return 0.0
    d = (prog.to(torch.float64) - ref.to(torch.float64)).abs().max()
    s = ref.to(torch.float64).abs().max().clamp(min=1e-30)
    v = float(d / s)
    return v if math.isfinite(v) else math.inf
