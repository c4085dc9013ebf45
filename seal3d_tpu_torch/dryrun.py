"""Multi-rank dry run of the train step (port of
`__graft_entry__.dryrun_multichip`): one train step on tiny shapes in each
of three layouts, over `n` ranks started by parallel/launch.py.

    python -m seal3d_tpu_torch.dryrun [--ranks 4] [--device cpu]
        [--partial_grid]

1. dp over n ranks (`make_mesh`), flat_frac 0.5: the Trainer derives
   pack_shards = n, and the step's collective log holds no batch-scale
   collective (>= num_rays * num_candidates / n elements:
   `find_batch_collectives`);
2. dp x tp (n_model = 2) on the `xla` backend with grid_shard_levels;
3. dp x tp on `halo` over the `wrap` gridtype (K1 over each rank's levels
   on the card), no `model` collective of a table's size.

Each phase runs a full grid update (a partial one with --partial_grid: a
sixth of the cells, what a CPU run can afford) and one step, and prints its
loss, which must be finite. Ranks run on the card unless --device cpu,
over gloo, so that they can share one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

# the reference's `_setup` widths, at its dry run's sizes
N_RAYS, HW, N_VIEWS, LOG2_T = 256, 16, 2, 12


def _setup(device):
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.train.trainer import TrainConfig

    ds = SyntheticScene().make_dataset(n_views=N_VIEWS, h=HW, w=HW, seed=0,
                                       device=device)
    fcfg = NGPConfig(bound=1.0, log2_hashmap_size=LOG2_T)
    opts = RenderOptions(bound=1.0, budget_per_ray=16, num_candidates=128,
                         max_steps=256, min_near=0.05)
    tcfg = TrainConfig(num_rays=N_RAYS, random_bg=False)
    return fcfg, opts, tcfg, ds


def _step(mesh, fcfg, opts, tcfg, ds, device, full_grid):
    """(trainer, loss) after a grid update and one train step."""
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.train.trainer import Trainer

    tr = Trainer(ngp, fcfg, opts, tcfg, dataset=ds, mesh=mesh,
                 device=device)
    tr.init_state()
    tr.update_grid(full=full_grid)
    loss = float(tr.train_step()["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dry run: non-finite loss {loss}")
    return tr, loss


def dryrun_rank(device, n: int, full_grid: bool = True) -> list:
    """What each rank runs -> [(phase tag, loss, collective log)]."""
    from seal3d_tpu_torch.parallel.mesh import (find_batch_collectives,
                                                find_table_collectives,
                                                make_mesh, make_mesh_2d)

    fcfg, opts, tcfg, ds = _setup(device)
    out = []
    mesh = make_mesh(n)
    tr, loss = _step(mesh, fcfg, dataclasses.replace(opts, flat_frac=0.5),
                     tcfg, ds, device, full_grid)
    if tr.opts.pack_shards != n:
        raise RuntimeError(f"pack_shards {tr.opts.pack_shards} != {n}")
    offenders = find_batch_collectives(
        mesh.log, tcfg.num_rays * opts.num_candidates // n)
    if offenders:
        raise RuntimeError(f"batch-scale collectives in the dp step: "
                           f"{offenders}")
    out.append(("dp, no-batch-collectives", loss, list(mesh.log)))

    n_model = 2 if n % 2 == 0 else 1
    mesh2 = make_mesh_2d(n // n_model, n_model)
    for backend, tag in (("xla", ""), ("halo", ", halo/-O")):
        kw = dict(grid_backend=backend, grid_shard_levels=True)
        if backend == "halo":
            kw["gridtype"] = "wrap"
        fcfg2 = dataclasses.replace(fcfg, **kw)
        _, loss = _step(mesh2, fcfg2, opts, tcfg, ds, device, full_grid)
        rows = fcfg2.grid.num_levels * 2**LOG2_T
        if find_table_collectives(mesh2.log, rows, n_model):
            raise RuntimeError(f"a table-sized collective over 'model': "
                               f"{mesh2.log}")
        out.append((f"dp{n // n_model} x tp{n_model}{tag}", loss,
                    list(mesh2.log)))
    return out


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 300.0,
                     full_grid: bool = True) -> list:
    """The three phases over `n` ranks; prints each phase's loss (rank 0's)
    and returns every rank's [(tag, loss, log)]."""
    from seal3d_tpu_torch.parallel.launch import launch

    if device == "cuda":
        from seal3d_tpu_torch.runtime.build import build_library

        build_library()     # once here, so the ranks do not race to build
    results = launch(dryrun_rank, n, args=(n, full_grid), backend="gloo",
                     device=device, timeout=timeout)
    for tag, loss, _ in results[0]:
        print(f"dryrun_multichip({n}): ok, loss={loss:.4f} [{tag}]")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--partial_grid", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (pass --device cpu)")
    dryrun_multichip(args.ranks, args.device,
                     full_grid=not args.partial_grid)


if __name__ == "__main__":
    main()
