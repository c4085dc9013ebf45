"""The edits' model FLOPs as a % of the card's peak (harness.step_mfu)."""

from benchmark import harness


def read(trace: harness.Trace):
    return harness.step_mfu(trace)
