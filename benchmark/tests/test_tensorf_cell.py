"""The cell seal-tensorf-bbox-preview on the CPU at a tiny size (factors at
16^3 with the published ranks, basis and MLP widths, Seal shells on
coarse grids, 2^12-point batches, 2 epochs), driven through the harness:
the port agrees with the TensoRF reference, the control and each planted
fault come out not correct; and the lookups' roofline arithmetic checked
by hand."""

import copy
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import roofline_tensorf as roof

CELL = "seal-tensorf-bbox-preview"
FAULTS = ("unchanged", "half_batch", "altered")


def run_tiny(capsys, probe=None, seed=2**31 + 12345):
    bench = harness.spec()
    cell, _, config, mix, gen = harness.cell_parts(bench, CELL)
    config = copy.deepcopy(config)
    config["model"]["resolution"] = [16, 16, 16]
    config["pretrain"].update(batch_size=2**12, epochs=2,
                              local_point_step=0.02,
                              surrounding_point_step=0.04,
                              global_point_step=0.2)
    ctx = harness.Context(workload=CELL, seed=seed, seconds=0.5, trace=False,
                          chips=cell["chips"], config=config, mix=mix,
                          t_start=time.perf_counter(),
                          device=torch.device("cpu"), probe=probe)
    assert harness.finish(bench, ctx, gen) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def tiny_run(capsys):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return lambda **kw: run_tiny(capsys, **kw)


def test_port_agrees_with_the_reference(tiny_run):
    line = tiny_run()
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"preview_s", "setup_s"}


@pytest.mark.parametrize("probe", ("control",) + FAULTS)
def test_control_and_faults_are_not_correct(tiny_run, probe):
    line = tiny_run(probe=probe)
    assert line["correct"] is False, line["checks"]


def test_lookup_bound_by_hand():
    """Two rows through one sigma pair (rank 16) forward and backward: a
    plane reads two coordinates (8 B) and writes 16 features (64 B) a row,
    a line one coordinate (4 B) and 16 features."""
    assert roof.lookup_bytes_ops("plane", 2, 32) == (2 * 8 + 4 * 32,
                                                    2 * 20 + 8 * 32)
    assert roof.lookup_bytes_ops("line", 2, 32) == (2 * 4 + 4 * 32,
                                                   2 * 10 + 4 * 32)
    counts = {"lookup_points": {"plane": 2, "line": 2},
              "lookup_rows": {"plane": 32, "line": 32},
              "scatter_points": {"plane": 2, "line": 2},
              "scatter_rows": {"plane": 32, "line": 32}}
    # every term is bound by its bytes: 144 + 136 B each way
    assert roof.lookup_least_seconds(counts) == pytest.approx(
        2 * (144 + 136) / 3.35e12)


def test_field_flops_by_hand():
    with open(f"{harness.ROOT}/benchmark/configs/seal-tensorf-VM.json") as f:
        model = json.load(f)["model"]
    fwd = roof.tensorf_forward_flops(model)
    # the colour MLP 150 -> 128 -> 128 -> 3, 2 a multiply-add
    assert fwd["mlp"] == 2 * (150 * 128 + 128 * 128 + 128 * 3) == 71_936
    # per pair of rank r: a plane (20 + 8r) and a line (10 + 4r) lookup and
    # the product (r; density's sum r more); the 144 x 27 basis product;
    # 30 encoded values x 2 degrees x 3; trunc_exp and 3 sigmoids of 4
    lookups = 3 * (30 + 12 * 16 + 2 * 16) + 3 * (30 + 12 * 48 + 48)
    assert lookups == 2_724
    assert fwd["fp32"] == lookups + 2 * 144 * 27 + 180 + 13 == 10_693
    pre = roof.tensorf_pretrain_flops(model)
    assert pre["mlp"] == 3 * 71_936
    assert pre["fp32"] == 2 * 10_693 + 2 * 144 * 27


def test_lookup_readers_by_hand():
    """Two lookup ranges on the device timeline, one kernel inside each and
    one outside, in a 10 ms window of 2 batches."""
    counts = {"lookup_points": {"plane": 2**20, "line": 2**20},
              "lookup_rows": {"plane": 2**24, "line": 2**24},
              "scatter_points": {"plane": 0, "line": 0},
              "scatter_rows": {"plane": 0, "line": 0}}
    tr = harness.Trace(
        window=(0.0, 0.010),
        kernels=[("index_select_kernel", 0.001, 0.002),
                 ("index_add_kernel", 0.004, 0.005),
                 ("adam_kernel", 0.006, 0.009)],
        ranges=[], launches=3,
        values={"batches": 2, "lookup_counts": counts,
                "lookup_ranges": {"tensorf.sample": [(0.0009, 0.0021)],
                                  "tensorf.scatter": [(0.0039, 0.0051)]}})
    assert roof.lookup_device_seconds(tr) == pytest.approx(0.002)
    load = harness.load_module
    ms = load(f"{harness.HERE}/metrics/lookup_ms.tfpreview.py", "lm_tf")
    rf = load(f"{harness.HERE}/metrics/lookup_roofline.tfpreview.py", "lr_tf")
    assert ms.read(tr) == pytest.approx(1.0)
    least = (8 * 2**20 + 4 * 2**24 + 4 * 2**20 + 4 * 2**24) / 3.35e12
    assert rf.read(tr) == pytest.approx(100 * least / 0.002)
    # a program without the counters or the backward's range reads None
    tr.values["lookup_ranges"]["tensorf.scatter"] = []
    assert ms.read(tr) is None and rf.read(tr) is None
