"""Kernel launch calls per pretraining batch over the traced edits: the
profiler's launch calls (init_pretraining's with them) over the batches."""

from benchmark import harness


def read(trace: harness.Trace):
    batches = trace.values.get("batches")
    return trace.launches / batches if batches else None
