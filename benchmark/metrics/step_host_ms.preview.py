"""ms of the host per pretraining batch: the mean duration of the
program's `pretrain.step` ranges (SealTrainer._pretrain_step) in the
traced window."""

from benchmark import harness


def read(trace: harness.Trace):
    lo, hi = trace.window
    steps = [e - s for n, s, e in trace.ranges
             if n == "pretrain.step" and lo <= s < hi]
    return 1e3 * sum(steps) / len(steps) if steps else None
