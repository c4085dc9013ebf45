"""K2's share of its roofline over the traced edits: the 'bucket' grid's
backward, the scatter of the table gradient (harness.kernel_roofline over
the launches the generator recorded)."""

from benchmark import harness


def read(trace: harness.Trace):
    return harness.kernel_roofline(trace, ("hash_encode_bwd",),
                                   trace.values.get("encode_bwd", []))
