"""Seconds of init_pretraining per edit, from the program's synced timer
(SealTrainer.train_edit's pretrain_init)."""

from benchmark import harness


def read(trace: harness.Trace):
    init = trace.values.get("edit_init_s")
    return sum(init) / len(init) if init else None
