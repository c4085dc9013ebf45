"""What decides `correct`, on the CPU at a tiny size: the port's plain CPU
path agrees with the benchmark's reference in every cell; the control (the
reference at the precision below the configuration's, in the program's
place) and each fault a cell can have, planted in the program, come out
not correct under the cell's own limits. The same readings at the cells'
own sizes are taken on the card with `benchmark/run.py --probe`."""

import pytest

CELLS = ("seal-bbox-preview", "seal-brush-preview")
FAULTS = ("unchanged", "half_batch", "altered")


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(tiny_run, workload):
    line = tiny_run(workload)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_run, workload):
    line = tiny_run(workload, probe="control")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload,fault",
                         [(w, f) for w in CELLS for f in FAULTS])
def test_fault_is_not_correct(tiny_run, workload, fault):
    line = tiny_run(workload, probe=fault)
    assert line["correct"] is False, line["checks"]
