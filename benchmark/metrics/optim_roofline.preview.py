"""% of its byte roofline that the fused Adam and EMA kernel reaches: the
launches of kernels whose names hold `adam_ema` in the traced window, times
the program's bytes a launch (ops/adam.py's process-wide counters: 36 B an
element of a moved leaf, 12 B an EMA-only one, fp32, over its launches),
over 3.35 TB/s, over those kernels' device time in the window. Every step
moves the same leaves, so the bytes a launch are exact. None where the
program has no such counters or no such kernel ran."""

import sys

from benchmark import harness

PEAK_BYTES_S = 3.35e12


def read(trace: harness.Trace):
    mod = sys.modules.get("seal3d_tpu_torch.ops.adam")
    launches = getattr(getattr(mod, "adam_ema", None), "launches", 0)
    served = (getattr(mod, "moved_bytes", 0)
              + getattr(mod, "ema_only_bytes", 0))
    if not launches or not served:
        return None
    lo, hi = trace.window
    runs = [(s, e) for n, s, e in trace.kernels
            if "adam_ema" in n and e > lo and s < hi]
    dev = sum(min(e, hi) - max(s, lo) for s, e in runs)
    if dev <= 0:
        return None
    return 100.0 * len(runs) * served / launches / PEAK_BYTES_S / dev
