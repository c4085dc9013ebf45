"""Traffic kind 'seal_preview_tensorf': Seal-3D's local stage on a TensoRF
VM student (`main_SealTensoRF.py`), as the same closed loop of edits as
'seal_preview' runs on NGP.

One edit is `SealTrainer.train_edit` on `models/tensorf.py` with no global
fine-tuning: `init_pretraining` (the three point shells, the proxy
mapper's mask and mapped points, the frozen teacher's answers cached for
them) and the configuration's pretraining epochs of 2^19-point batches,
every leaf but `aabb` moving, from the teacher's weights. Set-up builds one
`SealTrainer` over a teacher made from the seed by the plain reference
(`benchmark/reference/tensorf.py`) and runs one edit of one epoch,
recording its first three pretraining steps. The window runs whole edits
back to back until `--seconds` have passed; the value is its seconds over
the edits done. The traced run (`--trace 1`) profiles `trace_edits` edits
and records, beside the profile, the factor lookups' host counters' deltas
and their ranges' intervals on the device timeline.

Correctness, after the window and with the program's state freed, as in
'seal_preview' (its checks, against this field's reference): the shells'
row counts (exactly), the widest gap of the cached sigma and colour, the
recorded steps' losses, first gradient (from Adam's first moment) and the
change of every leaf and EMA leaf.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.hooks import flat_clone
from benchmark.reference import roofline_tensorf as roof
from benchmark.reference import seal as ref_seal
from benchmark.reference import tensorf as ref
from benchmark.traffic.seal_preview import (B1, FAULTS, StepRecorder,
                                            edit_config, init_checks, plant,
                                            pretrain_config, program_shells,
                                            step_checks, unplant)

OCC_CELLS = 128 ** 3        # the program's occupancy grid, one cascade
COUNTERS = ("lookup_points", "lookup_rows", "scatter_points", "scatter_rows")


def program_configs(config: dict):
    """(TensoRFConfig, RenderOptions, TrainConfig) of the port from the
    configuration."""
    from seal3d_tpu_torch.models.tensorf import TensoRFConfig
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.train.trainer import TrainConfig

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in d.items() if k in names}

    train = dict(config["train"], num_rays=4096, workspace=None)
    return (TensoRFConfig(**pick(TensoRFConfig, config["model"])),
            RenderOptions(**pick(RenderOptions, config["render"])),
            TrainConfig(**pick(TrainConfig, train)))


def counters():
    """A copy of the program's lookup counters (models/tensorf.py), or None
    where the program has none."""
    from seal3d_tpu_torch.models import tensorf

    if not all(hasattr(tensorf, c) for c in COUNTERS):
        return None
    return {c: dict(getattr(tensorf, c)) for c in COUNTERS}


def ref_steps(config, teacher, sh, prec, steps=3):
    """The reference's first `steps` pretraining batches -> (losses, first
    gradient, leaves after, EMA after)."""
    bs = ref_seal.batches(sh, config["pretrain"]["batch_size"])
    rp = ref.RefPretrainer(config["model"], config["pretrain"]["lr"],
                           teacher, prec)
    losses, g1 = [], None
    for i in range(steps):
        loss, grads = rp.step(bs[i % len(bs)])
        losses.append(loss)
        if i == 0:
            g1 = grads
    return losses, g1, rp.params, rp.ema


def run(ctx: harness.Context) -> harness.Outcome:
    from seal3d_tpu_torch.models import tensorf
    from seal3d_tpu_torch.seal.mappers import build_mapper
    from seal3d_tpu_torch.seal.trainer import SealTrainer

    config, mix, dev = ctx.config, ctx.mix, ctx.device
    model = config["model"]
    edit = edit_config(mix)
    if config["extra_epochs"]:
        raise ValueError("seal_preview_tensorf runs the local stage alone: "
                         "the configuration's extra_epochs must be 0")
    fcfg, opts, tcfg = program_configs(config)
    teacher = ref.make_params(model, ctx.seed, dev,
                              factor_scale=config["teacher_factor_scale"])
    bits = torch.zeros((OCC_CELLS // 8,), dtype=torch.uint8, device=dev)
    st = SealTrainer(tensorf, fcfg, opts, tcfg, build_mapper(edit),
                     teacher_params=ref.unflatten_like(
                         teacher, flat_clone(teacher)),
                     teacher_bitfield=bits, seed=0, device=dev)
    st.init_state()
    pcfg = pretrain_config(config)
    fault = ctx.probe if ctx.probe in FAULTS else None

    def edit_once(epochs=None):
        return st.train_edit(pcfg, finetune_steps=0, pretrain_epochs=epochs,
                             proxy=False, log=False)

    # the first steps from the teacher's weights, through the window's call
    if fault:
        plant(st, fault)
    rec = StepRecorder(st)
    edit_once(epochs=1)
    rec.close()
    prog_steps = dict(losses=[float(x) for x in rec.losses], mu1=rec.mu1,
                      params=rec.after[0], ema=rec.after[1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    harness.note(ctx, "set-up done")
    harness.note_clocks(ctx, "before the window")
    metrics, trace, edits, failed = {}, None, 0, 0
    if ctx.probe is None:
        unplant(st)
        t_open = time.perf_counter()
        metrics["setup_s"] = t_open - ctx.t_start
        n_loss = len(st.pretrain_losses)
        if not ctx.trace:
            while True:
                edit_once()
                edits += 1
                if time.perf_counter() - t_open >= ctx.seconds:
                    break
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            metrics["preview_s"] = (time.perf_counter() - t_open) / edits
        else:
            trace, edits = traced(st, ctx, edit_once, model)
        losses = st.pretrain_losses[n_loss:]
        per = max(len(losses) // max(edits, 1), 1)
        failed = sum(not np.all(np.isfinite(losses[i:i + per]))
                     for i in range(0, len(losses), per))
    prog_shells = program_shells(st)
    harness.note_clocks(ctx, "after the window")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    harness.note(ctx, f"window done: {edits} edits")
    mapper = ref_seal.build_mapper(edit, dev)
    refs = ref.shells(mapper, teacher, model, config["pretrain"], dev)
    harness.note(ctx, "reference shells built")
    before = flat_clone(teacher)
    steps_ref = ref_steps(config, teacher, refs, ref.STATED)
    harness.note(ctx, "reference steps done")
    if ctx.probe == "control":
        prog_shells = ref.shells(mapper, teacher, model, config["pretrain"],
                                 dev, ref.CONTROL)
        ctl = ref_steps(config, teacher, prog_shells, ref.CONTROL)
        prog_steps = dict(losses=[float(x) for x in ctl[0]],
                          mu1={k: (1 - B1) * g for k, g in ctl[1].items()},
                          params=ctl[2], ema=ctl[3])
    checks = (init_checks(mix["limits"], prog_shells, refs)
              + step_checks(mix["limits"], prog_steps, steps_ref, before))
    return harness.Outcome(metrics=metrics, checks=checks, attempted=edits,
                           failed=failed, memory_peak_bytes=peak, trace=trace)


def lookup_ranges(prof) -> dict:
    """{range name: [(start_s, end_s)]} of the lookups' ranges on the
    device timeline, on the clock of harness.collect (which leaves them out
    of its kernels)."""
    from torch.autograd import DeviceType

    out = {name: [] for name in roof.LOOKUP_RANGES}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.name() in out:
            start = e.start_ns() * 1e-9
            out[e.name()].append((start, start + e.duration_ns() * 1e-9))
    return out


def traced(st, ctx, edit_once, model):
    """Profile `trace_edits` edits -> (Trace, edits)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = ctx.mix["trace_edits"]
    timers = []
    before = counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(ctx.device)
        with record_function("bench.window"):
            for _ in range(n):
                timers.append(edit_once())
            torch.cuda.synchronize(ctx.device)
    after = counters()
    batches = sum(v["n_batches"] for v in st.pretrain_data.values())
    rows = sum(int(v["weight"].sum()) for v in st.pretrain_data.values())
    epochs = ctx.config["pretrain"]["epochs"]
    fwd = roof.tensorf_forward_flops(model)
    pre = roof.tensorf_pretrain_flops(model)
    # per edit: the teacher answers every shell row once (forward only),
    # then every epoch passes every row forward and backward
    flops = {k: n * rows * (fwd[k] + epochs * pre[k]) for k in fwd}
    window, kernels, ranges, launches = harness.collect(prof)
    return harness.Trace(
        window=window, kernels=kernels, ranges=ranges, launches=launches,
        values={"edits": n, "batches": n * epochs * batches,
                "model_flops": flops,
                "lookup_counts": None if before is None else {
                    c: {k: after[c][k] - before[c][k] for k in after[c]}
                    for c in COUNTERS},
                "lookup_ranges": lookup_ranges(prof),
                "edit_init_s": [t["pretrain_init"] for t in timers],
                "batch_s": [s / batches for s in
                            timers[-1]["pretraining"][-n * epochs:]]}), n
