"""Traffic kind 'seal_preview': Seal-3D's local stage on an NGP student, as
a closed loop of edits, each started when the last has finished.

One edit is what the user waits for before the edited student can be
previewed: `SealTrainer.train_edit` with no global fine-tuning, that is
`init_pretraining` (the three point shells, the proxy mapper's mask and
mapped points, the frozen teacher's answers cached for them) and the
published 100 pretraining epochs of 2^19-point batches, from the teacher's
weights. The edit is data (`benchmark/edits/<edit>.json`, a seal.json).

Set-up builds one `SealTrainer` over a teacher made from the seed and runs
one edit of one epoch through `train_edit`, recording its first three
pretraining steps. The window runs whole edits back to back until
`--seconds` have passed; the value is its seconds over the edits done. The
traced run (`--trace 1`) profiles `trace_edits` edits instead.

Correctness, after the window and with the program's state freed: the
plain reference (benchmark/reference/seal.py) builds the edit's shells
again and caches the teacher's answers; compared are the shells' row
counts (exactly) and the widest gap of the cached sigma and colour, on the
last edit the window ran, and the recorded steps' losses, first gradient
(from Adam's first moment) and the change of every grid and EMA leaf.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import compare, roofline
from benchmark.reference import ngp as ref
from benchmark.reference import seal as ref_seal
from benchmark.hooks import EncodeCalls, flat_clone, program_configs

FAULTS = ("unchanged", "half_batch", "altered")
B1 = 0.9
OCC_CELLS = 128 ** 3        # the program's occupancy grid, one cascade
SHELLS = ("local", "surrounding", "global")


def edit_config(mix: dict) -> dict:
    with open(os.path.join(harness.HERE, "edits", mix["edit"] + ".json")) as f:
        return json.load(f)


def pretrain_config(config: dict):
    from seal3d_tpu_torch.seal.trainer import PretrainConfig

    return PretrainConfig(**{k: v for k, v in config["pretrain"].items()
                             if k in PretrainConfig.__dataclass_fields__})


class StepRecorder:
    """Wraps a SealTrainer's `_pretrain_step` for its next 3 calls: the
    losses, Adam's first moment after the first, grids and EMA after the
    third."""

    def __init__(self, st, n: int = 3):
        self.st, self.n = st, n
        self.losses, self.mu1, self.after = [], None, None
        orig = st._pretrain_step

        def wrapped(batch):
            out = orig(batch)
            self.losses.append(out.clone())
            k = len(self.losses)
            if k == 1:
                self.mu1 = flat_clone(st._pre_opt_state[0].mu)
            if k == self.n:
                self.after = (flat_clone(st.state.params),
                              flat_clone(st.state.ema_params))
            return out

        st._pretrain_step = wrapped

    def close(self):
        del self.st._pretrain_step
        self.st = None


def plant(st, fault: str):
    """A fault in the program (for probes and tests only)."""
    if fault == "unchanged":
        orig = st._pretrain_step

        def still(batch):
            keep = st.state
            loss = orig(batch)
            st.state = keep
            return loss

        st._pretrain_step = still
    elif fault == "half_batch":
        orig = st.pretrain_loss

        def half(params, batch):
            # every other row: the padded tail of a shell's last batch
            # holds no row to leave out
            return orig(params, {k: v[::2] for k, v in batch.items()})

        st.pretrain_loss = half
    elif fault == "altered":
        orig = st._teacher_query

        def altered(points, dirs, qchunk=2**18):
            sigma, color = orig(points, dirs, qchunk)
            if sigma.numel():
                sigma = sigma.clone()
                sigma[sigma.numel() // 2] *= 2.0
            return sigma, color

        st._teacher_query = altered
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")


def unplant(st):
    for name in ("_pretrain_step", "pretrain_loss", "_teacher_query"):
        st.__dict__.pop(name, None)


def program_shells(st) -> dict:
    """The program's cached shells, unpadded: {shell: dict(points, dirs,
    sigma, color)} in row order."""
    out = {}
    for name, v in st.pretrain_data.items():
        w = v["weight"].reshape(-1)
        n = int(w.sum())
        out[name] = {k: v[k].reshape(-1, *v[k].shape[2:])[:n]
                     for k in ("points", "dirs", "sigma", "color")}
    return out


def init_checks(limits, prog: dict, refs: dict) -> list:
    count = sum(abs((prog[s]["points"].shape[0] if s in prog else 0)
                    - refs[s]["points"].shape[0]) for s in SHELLS)
    target = 0.0
    if count == 0:
        for s in SHELLS:
            if s not in prog:
                continue
            for k in ("points", "dirs"):
                if not torch.equal(prog[s][k], refs[s][k]):
                    target = math.inf
            target = max(target,
                         compare.widest_gap(prog[s]["sigma"], refs[s]["sigma"]),
                         compare.widest_gap(prog[s]["color"], refs[s]["color"]))
    else:
        target = math.inf
    return [harness.Check("count_gap", float(count), limits["count_gap"]),
            harness.Check("target_gap", target, limits["target_gap"])]


def ref_steps(config, teacher, sh, prec, steps=3):
    """The reference's first `steps` pretraining batches -> (losses, first
    gradient, grids after, EMA after)."""
    bs = ref_seal.batches(sh, config["pretrain"]["batch_size"])
    rp = ref_seal.RefPretrainer(config["model"], config["pretrain"]["lr"],
                                teacher, prec)
    losses, g1 = [], None
    for i in range(steps):
        loss, grads = rp.step(bs[i % len(bs)])
        losses.append(loss)
        if i == 0:
            g1 = grads
    return losses, g1, rp.params, rp.ema


def step_checks(limits, prog, refs, before) -> list:
    losses, g1, params, ema = refs
    g_prog = {k: prog["mu1"][k] / (1 - B1) for k in g1}
    keys = compare.moving(g1)
    allk = list(before)
    d_prog = {**{k: prog["params"][k] - before[k] for k in keys},
              **{"ema/" + k: prog["ema"][k] - before[k] for k in allk}}
    d_ref = {**{k: params[k] - before[k] for k in keys},
             **{"ema/" + k: ema[k] - before[k] for k in allk}}
    vals = {"loss_gap": compare.loss_gap(prog["losses"], losses),
            "grad_gap": compare.worst_leaf(g_prog, g1, keys),
            "change_gap": compare.worst_leaf(d_prog, d_ref)}
    return [harness.Check(k, v, limits[k]) for k, v in vals.items()]


def run(ctx: harness.Context) -> harness.Outcome:
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.seal.mappers import build_mapper
    from seal3d_tpu_torch.seal.trainer import SealTrainer

    config, mix, dev = ctx.config, ctx.mix, ctx.device
    model = config["model"]
    edit = edit_config(mix)
    if config["extra_epochs"]:
        raise ValueError("seal_preview runs the local stage alone: the "
                         "configuration's extra_epochs must be 0")
    fcfg, opts, tcfg = program_configs(config, num_rays=4096)
    teacher = ref.make_params(model, ctx.seed, dev,
                              table_scale=config["teacher_table_scale"])
    bits = torch.zeros((OCC_CELLS // 8,), dtype=torch.uint8, device=dev)
    st = SealTrainer(ngp, fcfg, opts, tcfg, build_mapper(edit),
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
    refs = ref_seal.shells(mapper, teacher, model, config["pretrain"], dev)
    harness.note(ctx, "reference shells built")
    before = flat_clone(teacher)
    steps_ref = ref_steps(config, teacher, refs, ref.STATED)
    harness.note(ctx, "reference steps done")
    if ctx.probe == "control":
        prog_shells = ref_seal.shells(mapper, teacher, model,
                                      config["pretrain"], dev, ref.CONTROL)
        ctl = ref_steps(config, teacher, prog_shells, ref.CONTROL)
        prog_steps = dict(losses=[float(x) for x in ctl[0]],
                          mu1={k: (1 - B1) * g for k, g in ctl[1].items()},
                          params=ctl[2], ema=ctl[3])
    checks = (init_checks(mix["limits"], prog_shells, refs)
              + step_checks(mix["limits"], prog_steps, steps_ref, before))
    return harness.Outcome(metrics=metrics, checks=checks, attempted=edits,
                           failed=failed, memory_peak_bytes=peak, trace=trace)


def traced(st, ctx, edit_once, model):
    """Profile `trace_edits` edits -> (Trace, edits)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = ctx.mix["trace_edits"]
    timers = []
    with EncodeCalls() as enc, profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(ctx.device)
        with record_function("bench.window"):
            for _ in range(n):
                timers.append(edit_once())
            torch.cuda.synchronize(ctx.device)
    batches = sum(v["n_batches"] for v in st.pretrain_data.values())
    rows = sum(int(v["weight"].sum()) for v in st.pretrain_data.values())
    epochs = ctx.config["pretrain"]["epochs"]
    fwd = roofline.ngp_field_flops(model)
    pre = roofline.ngp_pretrain_flops(model)
    # per edit: the teacher answers every shell row once (forward only),
    # then every epoch passes every row forward and backward
    mlp = n * rows * (fwd["mlp"] / 3.0 + epochs * pre["mlp"])
    fp32 = n * rows * (fwd["fp32"] / 2.0 + epochs * pre["fp32"])
    window, kernels, ranges, launches = harness.collect(prof)
    return harness.Trace(
        window=window, kernels=kernels, ranges=ranges, launches=launches,
        values={"edits": n, "batches": n * epochs * batches,
                "encode_fwd": enc.fwd, "encode_bwd": enc.bwd,
                "model_flops": {"mlp": mlp, "fp32": fp32},
                "edit_init_s": [t["pretrain_init"] for t in timers],
                "batch_s": [s / batches for s in
                            timers[-1]["pretraining"][-n * epochs:]]}), n
