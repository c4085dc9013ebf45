"""K3's share of its roofline over the traced edits: the hash-grid
encode's forward, the student's and the teacher's (harness.kernel_roofline
over the launches the generator recorded)."""

from benchmark import harness


def read(trace: harness.Trace):
    return harness.kernel_roofline(trace, ("hash_encode_fwd",),
                                   trace.values.get("encode_fwd", []))
