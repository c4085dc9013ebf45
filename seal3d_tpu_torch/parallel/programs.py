"""Rank programs: what each rank runs when parallel.launch starts them for a
check (the tests, chip_smoke.py), and the single-process runs they are held
against.

A spec is a dict of picklable values (configs, a NeRFDataset, numpy
arrays). `train_rank` trains an NGP Trainer on the spec's mesh and reports
its losses, params and step log; `encode_rank` runs the level-sharded
encode and its backward on the rank's rows and levels. With no "mesh" in
the spec, `train_rank` is the single-process run (the parent calls it
directly).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from seal3d_tpu_torch.parallel import mesh as pmesh


def _mesh(shape):
    if shape is None:
        return None
    if len(shape) == 1:
        return pmesh.make_mesh(shape[0])
    return pmesh.make_mesh_2d(*shape)


def _k1_counters():
    from seal3d_tpu_torch.ops import halo_encode as k1

    return (k1.halo_encode, k1.halo_encode_bwd, k1.halo_encode_levels)


def build_trainer(spec: dict, device, mesh=None):
    """An NGP Trainer of the spec ("fcfg", "opts", "tcfg", "dataset",
    "seed"), or with "dnerf" (DNeRFTrainer's keyword arguments) a D-NeRF
    one, its state initialized; with "params" (a numpy tree of whole
    tables) or "occ" (the fields of the trainer's occupancy state, numpy)
    those are installed."""
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.train.checkpoint import params_from_jax
    from seal3d_tpu_torch.train.dnerf_trainer import DNeRFTrainer
    from seal3d_tpu_torch.train.trainer import Trainer

    kw = dict(dataset=spec["dataset"], seed=spec.get("seed", 0),
              device=device, mesh=mesh)
    if "dnerf" in spec:
        tr = DNeRFTrainer(spec["fcfg"], spec["opts"], spec["tcfg"],
                          **spec["dnerf"], **kw)
    else:
        tr = Trainer(ngp, spec["fcfg"], spec["opts"], spec["tcfg"], **kw)
    tr.init_state()
    st = tr.state
    if "params" in spec:
        params = params_from_jax(spec["params"], device)
        st = st._replace(params=tr._shard_levels(params) if tr._tp
                         else params)
    if "occ" in spec:
        st = st._replace(occ=type(st.occ)(*[
            torch.as_tensor(np.array(a), device=device)
            for a in spec["occ"]]))
    tr.state = st
    return tr


def state_fingerprint(tr) -> str:
    """sha256 of the trainer's whole state (every leaf of full_state() in
    path order: params, Adam moments, EMA, occupancy, step, error map) and
    of its budget's operating point: the replicas of a mesh hold the same
    numbers, so they must agree on it exactly."""
    import hashlib

    from seal3d_tpu_torch.train.checkpoint import flatten_tree

    h = hashlib.sha256()
    for k, v in flatten_tree(tr.full_state()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    h.update(repr((tr.opts.budget_per_ray, tr.opts.flat_frac)).encode())
    return h.hexdigest()


def _step_random(r: dict, device):
    from seal3d_tpu_torch.train.trainer import StepRandom

    return StepRandom(**{k: None if v is None else torch.as_tensor(
        np.array(v), device=device) for k, v in r.items()})


def train_rank(device, spec: dict) -> dict:
    """Train per the spec and report. Keys read besides build_trainer's:
    "mesh" ((n,) or (n_data, n_model); absent: no mesh), "grid_first" (a
    grid update before the steps: full, or D-NeRF's slices), "rands" (a
    list of StepRandom fields as numpy arrays, one a step) or "steps" (that
    many steps drawn from the trainer's generator), "loop" (then that many
    steps of Trainer.train, grid updates included), "eval" (a dataset:
    then val PSNR), "k1_check" (on the card: hold the last step's first K1
    forward launch, whole or over a level range, against
    halo_encode_plain on the same inputs), "save_to" (a checkpoint path
    after the steps: every rank calls save_checkpoint, rank 0 writes).

    -> {"pack_shards", "losses", "num_samples", "grads" (the first step's
    gradients of the global batch, a level shard's under tensor
    parallelism), "params" (whole tables, numpy), "moved" (the mean |change|
    of the params over the steps), "error_map" (where the
    state has one), "saved" (the checkpoint path), "log" (the last step's
    collectives), "step_ms" (the loop's timing window), "psnr", "k1_err"
    and "k1_case" (that launch's rows, valid mask and levels), "launches"
    ({counter: launches in the steps}), "steps", "fingerprint"
    (`state_fingerprint` at the end)}."""
    from seal3d_tpu_torch.ops import halo_encode as k1
    from seal3d_tpu_torch.train.checkpoint import flatten_tree

    mesh = _mesh(spec.get("mesh"))
    tr = build_trainer(spec, device, mesh)
    if spec.get("grid_first"):   # D-NeRF: its cursor's slices
        tr.update_grid() if "dnerf" in spec else tr.update_grid(full=True)
    start = [v.detach().clone() for _, v in flatten_tree(
        tr.full_state().params)]
    rands = spec.get("rands") or [None] * spec.get("steps", 0)
    counters = _k1_counters()
    before = [c.launches for c in counters]
    out = {"pack_shards": tr.opts.pack_shards, "losses": [],
           "num_samples": [], "steps": len(rands)}
    seen, launch_fwd = [], k1._launch_fwd
    reduce_step = tr.reduce_step

    def first_grads(loss, grads, num_samples):
        res = reduce_step(loss, grads, num_samples)
        if "grads" not in out:
            out["grads"] = {k: v.detach().cpu().numpy()
                            for k, v in flatten_tree(res[1])}
        return res

    tr.reduce_step = first_grads

    def recording(table, x, valid, cfg, levels, *rest):
        res = launch_fwd(table, x, valid, cfg, levels, *rest)
        if not seen:
            seen.append((table.detach().clone(), x.clone(), valid, cfg,
                         levels, res.detach().clone()))
        return res

    for i, r in enumerate(rands):
        if i == len(rands) - 1 and spec.get("k1_check"):
            k1._launch_fwd = recording
        try:
            m = tr.train_step(None if r is None else _step_random(r, device))
        finally:
            k1._launch_fwd = launch_fwd
        out["losses"].append(float(m["loss"]))
        out["num_samples"].append(int(m["num_samples"]))
    tr.reduce_step = reduce_step
    out["launches"] = {c.__name__: c.launches - b
                       for c, b in zip(counters, before)}
    out["log"] = list(mesh.log) if mesh is not None else []
    if spec.get("k1_check"):
        if not seen:
            raise RuntimeError("k1_check: the last step launched no K1")
        table, x, valid, cfg, levels, res = seen[0]
        with torch.no_grad():
            ref = k1.halo_encode_plain(table, x, valid, cfg, levels)
        out["k1_err"] = float((res - ref).abs().max())
        out["k1_case"] = {"x": x.cpu().numpy(), "levels": levels,
                          "valid": None if valid is None
                          else valid.cpu().numpy()}
    full = tr.full_state()
    out["params"] = {k: v.detach().cpu().numpy()
                     for k, v in flatten_tree(full.params)}
    out["moved"] = float(torch.cat([(v.detach() - v0).abs().reshape(-1)
                                    for (_, v), v0 in zip(
                                        flatten_tree(full.params), start)])
                         .mean())
    if full.error_map is not None:
        out["error_map"] = full.error_map.cpu().numpy()
    if spec.get("save_to"):
        out["saved"] = tr.save_checkpoint(spec["save_to"])
    if spec.get("loop"):
        tr.train(spec["loop"], log_every=10**9)
        stats = tr.train_stats
        out["step_ms"] = (1e3 * stats["window_s"] / stats["window_steps"]
                          if stats["window_steps"] else None)
        out["loop_pack_shards"] = tr.opts.pack_shards
        out["loop_flat_frac"] = tr.opts.flat_frac
    if spec.get("eval") is not None:
        out["psnr"] = tr.evaluate(spec["eval"])
    out["fingerprint"] = state_fingerprint(tr)
    return out


def encode_rank(device, spec: dict) -> dict:
    """The level-sharded encode of spec["cfg"] (shard_levels, 'xla' or
    'halo') under make_mesh_2d(*spec["mesh"]): this rank's rows of
    spec["x"] (and "valid") at its levels of spec["table"] ([L*T, F],
    numpy), its backward against its rows of the cotangent spec["g"]
    ([M, L*F]), the table gradient summed over 'data' as the trainer sums
    it. -> {"coords", "out" [rows, L*F], "grad" (the shard's), "log",
    "seconds" (the forward and backward, synced)}."""
    from seal3d_tpu_torch.ops.hashgrid import hashgrid_encode
    from seal3d_tpu_torch.train.checkpoint import level_shard

    mesh = _mesh(spec["mesh"])
    pmesh.set_mesh(mesh)
    cfg = spec["cfg"]
    i, j = mesh.index("data"), mesh.index("model")
    n_data, n_model = mesh.size("data"), mesh.size("model")
    table = torch.as_tensor(spec["table"], device=device)
    shard = level_shard(table, cfg, n_model, j).clone().requires_grad_()
    rows = spec["x"].shape[0] // n_data
    part = slice(i * rows, (i + 1) * rows)
    x = torch.as_tensor(spec["x"][part], device=device)
    valid = (None if spec.get("valid") is None
             else torch.as_tensor(spec["valid"][part], device=device))
    g = torch.as_tensor(spec["g"][part], device=device)
    mesh.reset_log()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = hashgrid_encode(shard, x, cfg, valid=valid)
    (out * g).sum().backward()
    grad = pmesh.collective("all_reduce", shard.grad, mesh, "data", "grads")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"coords": (i, j), "out": out.detach().cpu().numpy(),
            "grad": grad.cpu().numpy(), "log": list(mesh.log),
            "seconds": time.perf_counter() - t0}


def mesh_then_plain_rank(device, spec: dict) -> dict:
    """A Trainer on spec["mesh"] takes a step, then `train_rank` trains one
    without a mesh on the rest of the spec in this process, then the first
    takes another step. -> {"plain" (train_rank's report), "ambient_none"
    (no ambient mesh after the second's run), "logged_on_mesh" (what the
    first's mesh logged meanwhile), "mesh_log" (the first's last step's
    collectives)}."""
    mesh = _mesh(spec["mesh"])
    first = build_trainer(spec, device, mesh)
    first.train_step()
    mesh.reset_log()
    plain = train_rank(device, {k: v for k, v in spec.items()
                                if k != "mesh"})
    ambient_none, logged = pmesh.current_mesh() is None, list(mesh.log)
    first.train_step()
    return {"plain": plain, "ambient_none": ambient_none,
            "logged_on_mesh": logged, "mesh_log": list(mesh.log)}


def unmatched_collective_rank(device, seconds: float) -> None:
    """Rank 0 enters an all_reduce that the other ranks skip (they wait
    `seconds`): the hung collective that parallel.launch's timeout turns
    into RankTimeout."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        dist.all_reduce(torch.zeros(1, device=device))
    else:
        time.sleep(seconds)


def run_all(device, jobs) -> list:
    """[fn(device, spec) for fn, spec in jobs]: several programs in one
    launch of the ranks."""
    return [fn(device, spec) for fn, spec in jobs]
