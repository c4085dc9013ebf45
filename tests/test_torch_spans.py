"""The port's named ranges and its pretraining row counters, on a tiny Seal
edit on the CPU.

A bbox edit of the benchmark's `seal-ngp-O` configuration, cut to 4 grid
levels at T=2^12, 2^12-point batches and coarse shells, runs 12
pretraining epochs (blocks of 10 and 2) under torch.profiler inside a
`bench.window` range, read through the benchmark harness's `collect`.
Checked: every range of the edit is there, inside its parent; the
timer's stage seconds are their ranges' durations; `span` is a null
context with no profiler on; the row counters; and the five span and
counter readers of `benchmark/metrics/` on a trace built by hand.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness
from benchmark.hooks import program_configs
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.seal import trainer as seal_trainer
from seal3d_tpu_torch.seal.mappers import build_mapper
from seal3d_tpu_torch.utils.trace import span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 12
# a timer stamp and its range's edge are taken one call apart
# (record_function's entry or exit, ~50 us); the room is for the host
# being preempted between them while other test workers run
CLOCK_TOL_S = 5e-3
# each range and the range that must hold it
PARENT = {"edit.init": "bench.window", "pretrain.block": "bench.window",
          "seal.sample": "edit.init", "seal.mask": "edit.init",
          "seal.teacher": "edit.init", "seal.pack": "edit.init",
          "pretrain.epoch": "pretrain.block",
          "pretrain.step": "pretrain.epoch",
          "pretrain.forward": "pretrain.step",
          "pretrain.backward": "pretrain.step",
          "pretrain.adam": "pretrain.step", "pretrain.ema": "pretrain.step"}
READERS = ("step_host_ms.preview", "step_wait_ms.preview",
           "optim_host_ms.preview", "mapper_s.preview",
           "useful_rows.preview")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reader(name: str):
    return harness.load_module(
        os.path.join(ROOT, "benchmark", "metrics", name + ".py"),
        "test_metric_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def edit(_two_torch_threads):
    """(trainer, timer, Trace, counted rows, counted slots) of one traced
    tiny bbox edit."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "seal-ngp-O.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "edits", "bbox.json")) as f:
        bbox = json.load(f)
    config["model"].update(num_levels=4, log2_hashmap_size=12)
    fcfg, opts, tcfg = program_configs(config, num_rays=256)
    pcfg = seal_trainer.PretrainConfig(**dict(
        config["pretrain"], batch_size=2**12, local_point_step=0.02,
        surrounding_point_step=0.04, global_point_step=0.2))
    teacher = tngp.init(fcfg, generator=torch.Generator().manual_seed(0))
    st = seal_trainer.SealTrainer(
        tngp, fcfg, opts, tcfg, build_mapper(bbox), teacher_params=teacher,
        teacher_bitfield=torch.zeros(128**3 // 8, dtype=torch.uint8),
        device="cpu")
    rows0, slots0 = seal_trainer.pretrain_rows, seal_trainer.pretrain_slots
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            timer = st.train_edit(pcfg, finetune_steps=0,
                                  pretrain_epochs=EPOCHS, proxy=False,
                                  log=False)
    window, kernels, ranges, launches = harness.collect(prof)
    trace = harness.Trace(window=window, kernels=kernels, ranges=ranges,
                          launches=launches)
    return (st, timer, trace, seal_trainer.pretrain_rows - rows0,
            seal_trainer.pretrain_slots - slots0)


def _named(trace, name):
    return sorted((s, e) for n, s, e in trace.ranges if n == name)


def test_span_is_a_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert span("pretrain.step") is span("edit.init")
    with span("pretrain.step") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("pretrain.step")
        assert isinstance(on, record_function)
        with on:
            pass
    assert [e.name for e in prof.events()].count("pretrain.step") == 1


def test_every_range_of_the_edit_lies_in_its_parent(edit):
    st, _, trace, _, _ = edit
    for child, parent in PARENT.items():
        spans = _named(trace, child)
        assert spans, child
        outer = _named(trace, parent)
        for s, e in spans:
            assert any(ps <= s and e <= pe for ps, pe in outer), \
                (child, parent)
    batches = sum(v["n_batches"] for v in st.pretrain_data.values())
    assert len(st.pretrain_data) == 3 and batches > 3
    assert len(_named(trace, "pretrain.step")) == EPOCHS * batches
    assert len(_named(trace, "pretrain.epoch")) == EPOCHS
    assert len(_named(trace, "pretrain.block")) == 2
    # each of the three shells samples its grid and its directions
    assert len(_named(trace, "seal.sample")) == 6
    assert len(_named(trace, "seal.mask")) == 3
    assert len(_named(trace, "seal.teacher")) == 3
    assert len(_named(trace, "edit.init")) == len(_named(trace, "seal.pack")) \
        == 1


def test_timer_seconds_are_their_ranges(edit):
    _, timer, trace, _, _ = edit
    (s, e), = _named(trace, "edit.init")
    assert abs(timer["pretrain_init"] - (e - s)) < CLOCK_TOL_S
    blocks = _named(trace, "pretrain.block")
    per_epoch = timer["pretraining"]
    assert len(per_epoch) == EPOCHS
    got = [sum(per_epoch[:10]), sum(per_epoch[10:])]
    for t, (s, e) in zip(got, blocks):
        assert abs(t - (e - s)) < CLOCK_TOL_S


def test_row_counters(edit):
    st, _, _, rows, slots = edit
    shells = st.pretrain_data.values()
    assert all(v["n_rows"] == int(v["weight"].sum()) for v in shells)
    assert rows == EPOCHS * sum(v["n_rows"] for v in shells)
    assert slots == EPOCHS * sum(v["n_batches"] for v in shells) * 2**12
    assert rows < slots


def test_readers_find_the_edit(edit):
    _, timer, trace, _, _ = edit
    got = {n: reader(n).read(trace) for n in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    # the CPU trace has no device activity: a step waits all through
    assert got["step_wait_ms.preview"] == pytest.approx(
        got["step_host_ms.preview"])
    assert got["optim_host_ms.preview"] < got["step_host_ms.preview"]
    assert got["mapper_s.preview"] < timer["pretrain_init"]
    assert got["useful_rows.preview"] == pytest.approx(
        100.0 * seal_trainer.pretrain_rows / seal_trainer.pretrain_slots)


def test_readers_by_hand(monkeypatch):
    """Two edits' ranges and three kernels laid out by hand, in seconds."""
    ranges = [("bench.window", 0.0, 10.0),
              ("edit.init", 0.0, 1.0), ("seal.mask", 0.1, 0.3),
              ("seal.mask", 0.5, 0.6),
              ("pretrain.step", 1.0, 1.5), ("pretrain.adam", 1.3, 1.4),
              ("pretrain.ema", 1.4, 1.45),
              ("pretrain.step", 2.0, 3.0), ("pretrain.adam", 2.5, 2.6),
              ("pretrain.ema", 2.6, 2.7),
              ("edit.init", 5.0, 5.5), ("seal.mask", 5.1, 5.2),
              ("pretrain.step", 6.0, 6.5), ("pretrain.adam", 6.2, 6.3),
              ("pretrain.ema", 6.3, 6.35),
              ("aten::mm", 6.0, 6.1),
              # outside the window
              ("pretrain.step", 11.0, 12.0), ("seal.mask", 11.0, 13.0)]
    # busy: [1.1, 1.3] and [1.2, 1.4] merge into [1.1, 1.4]; [2.9, 3.5]
    # overlaps the second step by 0.1; [4, 5] overlaps no step
    kernels = [("k", 1.1, 1.3), ("k", 1.2, 1.4), ("k", 2.9, 3.5),
               ("k", 4.0, 5.0)]
    trace = harness.Trace(window=(0.0, 10.0), kernels=kernels,
                          ranges=ranges, launches=4)
    # steps 0.5 + 1.0 + 0.5 s; idle in them 0.2 + 0.9 + 0.5 s
    assert reader("step_host_ms.preview").read(trace) == pytest.approx(
        1e3 * 2.0 / 3)
    assert reader("step_wait_ms.preview").read(trace) == pytest.approx(
        1e3 * 1.6 / 3)
    assert reader("optim_host_ms.preview").read(trace) == pytest.approx(
        1e3 * (0.1 + 0.05 + 0.1 + 0.1 + 0.1 + 0.05) / 3)
    assert reader("mapper_s.preview").read(trace) == pytest.approx(0.4 / 2)
    monkeypatch.setattr(seal_trainer, "pretrain_rows", 1_518_880)
    monkeypatch.setattr(seal_trainer, "pretrain_slots", 2_621_440)
    assert reader("useful_rows.preview").read(trace) == pytest.approx(
        57.94, abs=5e-3)
    # a program without the ranges or the counters: no reading
    bare = harness.Trace(window=(0.0, 10.0), kernels=kernels,
                         ranges=[("bench.window", 0.0, 10.0)], launches=4)
    monkeypatch.delattr(seal_trainer, "pretrain_rows")
    for name in READERS:
        assert reader(name).read(bare) is None, name
