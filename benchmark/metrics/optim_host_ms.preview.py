"""ms of the host per pretraining batch in the optimizer: the durations of
the program's `pretrain.adam` and `pretrain.ema` ranges in the traced
window, over its `pretrain.step` ranges."""

from benchmark import harness


def read(trace: harness.Trace):
    lo, hi = trace.window
    inside = [(n, e - s) for n, s, e in trace.ranges if lo <= s < hi]
    steps = sum(n == "pretrain.step" for n, _ in inside)
    optim = sum(d for n, d in inside if n in ("pretrain.adam", "pretrain.ema"))
    return 1e3 * optim / steps if steps else None
