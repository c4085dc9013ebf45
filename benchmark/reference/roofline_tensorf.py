"""The TensoRF field's yardstick: the factor lookups' bytes and operations
and their least time, the device time they took in a traced window, and
the model FLOPs of a Seal-3D pretraining step on the field.

The lookups are counted as `roofline.encode_bytes_ops` counts the hash-grid
encode: per looked-up row its coordinates once (a plane's two, a line's
one: fp32) and its R features once (forward: written; backward: the
cotangent read), the factor itself left out (which of its cells a batch
touches depends on the points), so the least time is a lower bound. Per
row and component a plane blends 4 corners (a multiply and an add each)
and a line 2; per row ~20 operations of a plane's index and weights, ~10
of a line's. The program's host counters give the rows
(`models/tensorf.py`: `lookup_points`, `lookup_rows` forward,
`scatter_points`, `scatter_rows` backward).
"""

from __future__ import annotations

import bisect

from benchmark.reference.roofline import least_seconds, mlp_flops
from benchmark.reference.tensorf import color_dims

KINDS = {"plane": (8, 20, 8), "line": (4, 10, 4)}   # coord B, ops a row,
                                                   # ops a row-component
LOOKUP_RANGES = ("tensorf.sample", "tensorf.scatter")


def lookup_bytes_ops(kind: str, points: int, rows: int) -> tuple:
    """(bytes, operations) of `points` lookups of a `kind` factor that
    gather (or scatter) `rows` row-components in all."""
    coord, per_point, per_row = KINDS[kind]
    return (float(coord * points + 4 * rows),
            float(per_point * points + per_row * rows))


def lookup_least_seconds(counts: dict) -> float:
    """The least time of the counted lookups: per direction and kind, the
    larger of bytes over the HBM peak and operations over the fp32 peak.
    `counts`: {"lookup_points": {kind: n}, "lookup_rows": {kind: n},
    "scatter_points": ..., "scatter_rows": ...}."""
    return sum(least_seconds(*lookup_bytes_ops(
        kind, counts[f"{d}_points"][kind], counts[f"{d}_rows"][kind]))
        for d in ("lookup", "scatter") for kind in KINDS)


def lookup_device_seconds(trace):
    """Device seconds in the traced window of the kernels that ran inside
    the lookups' device-side ranges (`values["lookup_ranges"]`: the
    profiler's `tensorf.sample` and `tensorf.scatter` annotations on the
    device timeline), or None where either range is missing."""
    got = trace.values.get("lookup_ranges") or {}
    if not all(got.get(name) for name in LOOKUP_RANGES):
        return None
    lo, hi = trace.window
    merged = []
    for s, e in sorted(iv for name in LOOKUP_RANGES for iv in got[name]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ends = [e for _, e in merged]
    total = 0.0
    for _, s, e in trace.kernels:
        i = bisect.bisect_right(ends, s)
        while i < len(merged) and merged[i][0] < e:
            total += min(e, merged[i][1]) - max(s, merged[i][0])
            i += 1
    return total


def tensorf_forward_flops(model: dict) -> dict:
    """The field's forward per point, split by the peak it runs at:
    {"mlp": the colour MLP's products (bf16 operands), "fp32": the
    lookups, the plane x line products and sums, the basis product, the
    frequency encoding and the activations}."""
    lookups = 0
    for nm in ("sigma", "color"):
        for r in model[f"{nm}_rank"]:
            # a plane and a line lookup, their product, the density's sum
            lookups += (sum(lookup_bytes_ops(k, 1, r)[1] for k in KINDS)
                        + r * (2 if nm == "sigma" else 1))
    basis = 2 * sum(model["color_rank"]) * model["color_feat_dim"]
    # per encoded value and degree: a scaling, a sine and a cosine
    enc = 3 * (model["color_feat_dim"] + 3) * model["freq_degree"]
    act = 1 + 3 * 4                     # trunc_exp, the sigmoids
    return {"mlp": float(mlp_flops(color_dims(model))),
            "fp32": float(lookups + basis + enc + act)}


def tensorf_pretrain_flops(model: dict) -> dict:
    """Per pretraining point: the forward and its backward, which moves
    every leaf but `aabb`: the MLP's and the basis product's input and
    weight gradients (2x their forward), the lookups' scatters and the
    elementwise chain's cotangents (1x)."""
    fwd = tensorf_forward_flops(model)
    basis = 2 * sum(model["color_rank"]) * model["color_feat_dim"]
    return {"mlp": 3.0 * fwd["mlp"], "fp32": 2.0 * fwd["fp32"] + basis}
