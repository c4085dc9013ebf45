"""Seconds per edit of the proxy mapper's mask over the shells' points:
the program's `seal.mask` ranges (each ends in the `nonzero` that syncs
the host, so it holds the mapper's device time) over its `edit.init`
ranges in the traced window."""

from benchmark import harness


def read(trace: harness.Trace):
    lo, hi = trace.window
    inside = [(n, e - s) for n, s, e in trace.ranges if lo <= s < hi]
    edits = sum(n == "edit.init" for n, _ in inside)
    mask = sum(d for n, d in inside if n == "seal.mask")
    return mask / edits if edits else None
