"""% of the TensoRF VM lookups' scattered corner rows that the backward sent
to the L2 as atomics: the program's device counter `scatter_atomic_comps`
(seal3d_tpu_torch.models.tensorf, the components its VM kernel's backward
sent after merging runs of points in one cell) over the components of four
corner rows a plane row and two a line row (`scatter_rows`). Both count the
whole process; set-up's edit and the traced one scatter the same shells,
so the share is the traced edit's. None where the program has no such
counter or has sent nothing through it."""

import sys

from benchmark import harness


def read(trace: harness.Trace):
    mod = sys.modules.get("seal3d_tpu_torch.models.tensorf")
    comps = getattr(mod, "scatter_atomic_comps", None)
    rows = getattr(mod, "scatter_rows", None)
    if not comps or not rows:
        return None
    import torch

    torch.cuda.synchronize()
    sent = sum(int(t) for t in comps.values())
    whole = 4 * rows["plane"] + 2 * rows["line"]
    return 100.0 * sent / whole if whole else None
