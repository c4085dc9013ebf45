"""ms per pretraining batch in which the card ran nothing while the host
was inside a `pretrain.step` range: the steps' seconds less their overlap
with harness.busy_intervals, over the number of steps."""

import bisect

from benchmark import harness


def read(trace: harness.Trace):
    lo, hi = trace.window
    steps = [(max(s, lo), min(e, hi)) for n, s, e in trace.ranges
             if n == "pretrain.step" and e > lo and s < hi]
    if not steps:
        return None
    busy = harness.busy_intervals(trace.kernels, trace.window)
    ends = [e for _, e in busy]
    idle = 0.0
    for s, e in steps:
        idle += e - s
        i = bisect.bisect_right(ends, s)
        while i < len(busy) and busy[i][0] < e:
            idle -= min(e, busy[i][1]) - max(s, busy[i][0])
            i += 1
    return 1e3 * idle / len(steps)
