"""% of the pretraining's computed rows that are the shells' own rows, not
the weight-0 padding of a shell's last batch: the program's host counters
`pretrain_rows` and `pretrain_slots` (seal3d_tpu_torch.seal.trainer). They
count the whole process; set-up's edit and the traced one have the same
shells, so the share is the traced edit's."""

import sys

from benchmark import harness


def read(trace: harness.Trace):
    mod = sys.modules.get("seal3d_tpu_torch.seal.trainer")
    rows = getattr(mod, "pretrain_rows", None)
    slots = getattr(mod, "pretrain_slots", None)
    return 100.0 * rows / slots if rows is not None and slots else None
