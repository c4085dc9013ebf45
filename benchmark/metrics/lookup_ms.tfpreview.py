"""Device ms of the TensoRF factor lookups per pretraining batch: the device
time of the kernels inside the lookups' ranges on the device timeline
(`tensorf.sample` forward, `tensorf.scatter` backward; the teacher's
lookups in `edit.init` count too), over the traced window's batches. None
where the program opens no such ranges."""

from benchmark import harness
from benchmark.reference import roofline_tensorf


def read(trace: harness.Trace):
    dev = roofline_tensorf.lookup_device_seconds(trace)
    batches = trace.values.get("batches")
    return 1e3 * dev / batches if dev and batches else None
