"""Shared helpers of the benchmark's CPU tests: a cell of BENCHMARK.json
cut to a size the CPU runs in seconds (4 grid levels of at most 2^12 rows,
Seal shells on coarse grids, 2^12-point batches, 2 epochs), driven through
the harness with the card's check skipped."""

import copy
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def tiny(config: dict, mix: dict):
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["model"].update(num_levels=4, log2_hashmap_size=12)
    config["pretrain"].update(batch_size=2**12, epochs=2,
                              local_point_step=0.02,
                              surrounding_point_step=0.04,
                              global_point_step=0.2)
    return config, mix


def run_tiny(workload: str, seed: int = 2**31 + 12345, probe=None,
             bench=None, capsys=None):
    """The result line of a tiny CPU run of `workload` (a dict), as
    harness.finish prints it."""
    bench = bench or harness.spec()
    cell, _, config, mix, gen = harness.cell_parts(bench, workload)
    config, mix = tiny(config, mix)
    ctx = harness.Context(workload=workload, seed=seed, seconds=0.5,
                          trace=False, chips=cell["chips"], config=config,
                          mix=mix, t_start=time.perf_counter(),
                          device=torch.device("cpu"), probe=probe)
    assert harness.finish(bench, ctx, gen) == 0
    import json

    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def tiny_run(capsys):
    torch.set_num_threads(min(4, torch.get_num_threads()))

    def go(workload, **kw):
        return run_tiny(workload, capsys=capsys, **kw)

    return go
