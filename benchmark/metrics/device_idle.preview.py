"""% of the traced edits' window with nothing running on the card."""

from benchmark import harness


def read(trace: harness.Trace):
    return harness.device_idle(trace)
