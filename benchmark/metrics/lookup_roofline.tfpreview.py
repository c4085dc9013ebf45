"""The TensoRF factor lookups' share of their roofline over the traced
edits: the least time of the rows the program's counters say were gathered
and scattered (roofline_tensorf.lookup_least_seconds, from the counters'
deltas over the window), over the device time of the lookups' ranges
(roofline_tensorf.lookup_device_seconds). None where the program has no
such counters or ranges."""

from benchmark import harness
from benchmark.reference import roofline_tensorf


def read(trace: harness.Trace):
    counts = trace.values.get("lookup_counts")
    dev = roofline_tensorf.lookup_device_seconds(trace)
    if not counts or not dev:
        return None
    return 100.0 * roofline_tensorf.lookup_least_seconds(counts) / dev
