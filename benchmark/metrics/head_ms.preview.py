"""Device ms of the NGP field head per pretraining batch: the device time
in the traced window of the kernels whose names hold `field_head` (the
field head's forward and backward, ops/field_head.py), over the window's
pretraining batches. None where no such kernel ran."""

from benchmark import harness


def read(trace: harness.Trace):
    lo, hi = trace.window
    dev = sum(min(e, hi) - max(s, lo) for n, s, e in trace.kernels
              if "field_head" in n and e > lo and s < hi)
    batches = trace.values.get("batches")
    return 1e3 * dev / batches if dev > 0 and batches else None
