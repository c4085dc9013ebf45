"""Seal student trainer: two-stage teacher -> student distillation (port of
seal3d_tpu/seal/trainer.py).

Stage 1, local pretraining (`init_pretraining`, `pretrain_*`): dense grids
of points are sampled in three shells (local = the edit region, surrounding
= the extended bounds minus the edit region, global = the whole scene box),
the ground-truth sigma and colour are queried once from the frozen teacher
through the proxy mapping, then the student is fitted with L1 on (log1p
sigma, colour) at a high constant learning rate. What moves depends on the
family (`_pretrain_leaves`): NGP's hash tables (its MLPs are frozen), every
TensoRF leaf but `aabb` (and the buffers `T`, `R`).

Stage 2, global finetuning: every training view is rendered once by the
mapped teacher (`proxy_datasets`) and normal image training resumes with the
depth term, the edit region force-filled in the occupancy bitfield; a last
un-hacked grid update (`restore_grid`) then drops the force-fill.

The timing of both stages goes to `<workspace>/timer.json`, the run's
configuration to `seal.json` / `options.json` / `run.sh`. PyTorch runs
eagerly: the reference's scan-fused pretrain block is a plain loop here, and
its recovery of donated buffers has no counterpart.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np
import torch

from seal3d_tpu_torch.data.rays import get_full_rays
from seal3d_tpu_torch.ops.raymarch import march_candidates
from seal3d_tpu_torch.render.renderer import RenderOptions, render_rays
from seal3d_tpu_torch.seal import geometry as geo
from seal3d_tpu_torch.seal.mappers import SealMapper, map_color, map_to_origin
from seal3d_tpu_torch.seal.provider import proxy_dataset
from seal3d_tpu_torch.seal.renderer import (cells_to_byte_masks,
                                            force_fill_cells, hack_bitfield,
                                            make_teacher_field)
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates
from seal3d_tpu_torch.train.trainer import TrainConfig, Trainer

_BATCH_KEYS = ("points", "dirs", "sigma", "color", "weight")


@dataclass
class PretrainConfig:
    """The reference's PretrainConfig: same fields and defaults."""

    epochs: int = 100
    # large batches matter: small batches and Adam's stale momentum on
    # sparsely touched hash entries destabilise the distillation
    batch_size: int = 2**19
    lr: float = 0.07
    local_point_step: float = 0.005
    local_angle_step: float = 45.0
    surrounding_point_step: float = 0.01
    surrounding_angle_step: float = 45.0
    surrounding_bounds_extend: float = 0.2
    global_point_step: float = 0.05
    global_angle_step: float = 45.0
    export_debug: bool = False
    # L1 on log1p(sigma) instead of raw sigma: with sigma = exp(h) the raw
    # L1 gradient vanishes exactly where density must be raised from empty
    # space (the edit target); log-space L1 converges both ways
    sigma_log_space: bool = True


def sample_grid_points(bounds: np.ndarray, step: float, angle_step: float,
                       max_points: int = 4_000_000):
    """Regular grid over AABB(s) [B, 2, 3] plus an euler-angle direction
    set -> (points [P, 3], dirs [D, 3]) f32; a grid over `max_points` halves
    its counts until it fits."""
    bounds = np.asarray(bounds, np.float32).reshape(-1, 2, 3)
    pts = []
    for lo, hi in bounds:
        counts = np.maximum(((hi - lo) / step).astype(np.int64), 1)
        while np.prod(counts) > max_points:
            counts = np.maximum(counts // 2, 1)
        axes = [np.linspace(lo[d], hi[d], int(counts[d])) for d in range(3)]
        pts.append(np.stack(np.meshgrid(*axes, indexing="ij"), -1)
                   .reshape(-1, 3))
    points = np.concatenate(pts).astype(np.float32)

    angles = np.deg2rad(np.arange(0.0, 360.0, angle_step))
    dirs = np.asarray([[np.cos(a) * np.sin(b), np.sin(a) * np.sin(b), np.cos(b)]
                       for a in angles
                       for b in angles[: len(angles) // 2 + 1]], np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12
    return points, dirs


def _pretrain_leaves(params: dict) -> dict:
    """The top-level entries the pretraining moves: an NGP field (it has a
    `sigma_net`) its hash tables, its MLPs frozen; the TensoRF family
    everything but the geometric buffers `aabb`, `T` and `R`."""
    if "sigma_net" in params:
        return {k: v for k, v in params.items() if "encoder" in k}
    return {k: v for k, v in params.items() if k not in ("aabb", "T", "R")}


class SealTrainer(Trainer):
    """Student trainer. The teacher (field, params, bitfield) is frozen."""

    def __init__(self, field_mod, field_cfg, opts: RenderOptions,
                 cfg: TrainConfig, mapper: SealMapper, teacher_params,
                 teacher_bitfield, dataset=None, seed: int = 0, device=None,
                 secondary_field=None, secondary_cfg=None,
                 secondary_params=None, name: str = "seal_student",
                 mesh=None):
        super().__init__(field_mod, field_cfg, opts, cfg, dataset=dataset,
                         seed=seed, device=device, name=name, mesh=mesh)
        dev = self.device

        def on_device(tree):
            return ckpt_io.map_tree(tree, lambda _, t: t.detach().to(dev))

        self.mapper = mapper.to(dev)
        self.teacher_params = on_device(teacher_params)
        self.teacher_field = make_teacher_field(
            field_mod, self.mapper, field_cfg, secondary_field, secondary_cfg,
            None if secondary_params is None else on_device(secondary_params))
        # edit-region occupancy force-fill, precomputed on the host
        cells = force_fill_cells(mapper.force_fill_bound, opts.cascades,
                                 opts.bound)
        byte_idx, masks = cells_to_byte_masks(cells)
        self._hack_bytes = torch.from_numpy(byte_idx.astype(np.int64)).to(dev)
        self._hack_masks = torch.from_numpy(masks).to(dev)
        # march-AABB expansion covering the (initially empty) edit region
        ffb = np.asarray(mapper.force_fill_bound, np.float32).reshape(-1, 2, 3)
        self._hack_aabb = torch.from_numpy(
            np.concatenate([ffb[:, 0].min(0), ffb[:, 1].max(0)])).to(dev)
        self.teacher_bitfield = hack_bitfield(
            torch.as_tensor(teacher_bitfield).to(dev), self._hack_bytes,
            self._hack_masks)
        # teacher renders (proxies, previews): the train options at the eval
        # budget, packed only at a budget that a demand probe has shown to
        # cover the chunk (an overflowing pack would thin the proxy targets)
        self._teacher_opts = dataclasses.replace(
            opts, budget_per_ray=cfg.eval_budget_per_ray, flat_frac=None)
        self.pretrain_data = {}
        self.is_pretraining = False
        self.time_inspector = {"pretraining": [], "training": []}
        # the last proxy_datasets call: views, and its chunks by branch
        self.proxy_stats = {}
        self.pretrain_losses = []   # per epoch, over train_edit's stage 1

    # ------------------------------------------------------------ teacher side

    def _teacher_view_setup(self, pose, h, w, chunk):
        """Z-order chunk layout and padded ray stacks of one teacher view ->
        (rays_o [n_chunks, chunk, 3], rays_d, inverse permutation); pad
        slots hold rays behind the scene box (zero demand)."""
        dev = self.device
        sel, _, inv = self._chunk_layout(h, w, chunk)
        rays = get_full_rays(torch.as_tensor(pose, dtype=torch.float32,
                                             device=dev),
                             self._intrinsics, h, w)
        selt = torch.from_numpy(np.clip(sel, 0, None)).to(dev)
        ok = torch.from_numpy(sel >= 0).to(dev)[..., None]
        b = self.opts.bound
        ro_c = torch.where(ok, rays["rays_o"][selt],
                           torch.tensor([3.0 * b, 0.0, 0.0], device=dev))
        rd_c = torch.where(ok, rays["rays_d"][selt],
                           torch.tensor([1.0, 0.0, 0.0], device=dev))
        return ro_c, rd_c, torch.from_numpy(inv).to(dev)

    @torch.no_grad()
    def _teacher_demand(self, bitfield, rays_o, rays_d) -> torch.Tensor:
        """[] int64: the exact kept-sample count of the teacher march over
        a chunk, grid branch and packed branch alike (the candidates, then
        the per-ray stride cap of compact_topk / compact_flat_direct)."""
        to = self._teacher_opts
        _, _, valid = march_candidates(
            rays_o, rays_d, bitfield, to.bound, to.cascades, to.dt_gamma,
            to.max_steps, to.num_candidates, min_near=to.min_near,
            occ_stride=to.occ_stride, coarse_steps=to.coarse_steps)
        rank = torch.cumsum(valid.to(torch.int64), dim=1)
        stride = torch.ceil(rank[:, -1:] / to.budget_per_ray) \
            .to(torch.int64).clamp(min=1)
        return (valid & (((rank - 1) % stride) == 0)).sum()

    def _covering_frac(self, need: float, chunk: int):
        """The smallest flat_frac bucket whose budget covers `need` kept
        samples (1.02 absorbs the round-to-128); None (the [N, K] grid
        branch) when no bucket under 1.0 does: the proxy targets must never
        thin. 0.0: the chunk has no occupied sample at all and renders to
        the background (not under a background net)."""
        if need == 0 and self.opts.bg_radius <= 0:
            return 0.0
        cap = chunk * self._teacher_opts.budget_per_ray
        for b in self.cfg.eval_buckets:
            if b < 1.0 and max(int(round(cap * b / 128)) * 128,
                               128) >= need * 1.02:
                return b
        return None

    @torch.no_grad()
    def render_teacher_view(self, pose, h=None, w=None, chunk=None,
                            bg_color: float = 1.0, fracs=None):
        """One full view through the mapped teacher, Z-order chunked like
        `render_image` -> (image [h, w, 3], depth [h, w]) tensors, with no
        host sync when `fracs` is given. `fracs`, per chunk: 0.0 = skip
        (background), a float = packed at that covering flat_frac, None =
        the [N, K] grid branch; without it each chunk probes its own demand
        and syncs (fine for a preview, serialising for a stack of views)."""
        h = h or self.dataset.h
        w = w or self.dataset.w
        chunk = chunk or min(self.cfg.eval_chunk, h * w)
        dev = self.device
        ro_c, rd_c, inv = self._teacher_view_setup(pose, h, w, chunk)
        bg = torch.full((chunk, 3), bg_color, dtype=torch.float32, device=dev)
        imgs, deps = [], []
        for ci in range(ro_c.shape[0]):
            if fracs is not None:
                frac = fracs[ci]
            elif self.opts.compaction == "topk":
                frac = self._covering_frac(
                    float(self._teacher_demand(self.teacher_bitfield,
                                               ro_c[ci], rd_c[ci])), chunk)
            else:
                frac = None
            if frac == 0.0:
                imgs.append(bg)
                deps.append(torch.zeros((chunk,), dtype=torch.float32,
                                        device=dev))
                continue
            out = render_rays(
                self.teacher_params, self.teacher_field, self.fcfg,
                self.teacher_bitfield, ro_c[ci], rd_c[ci],
                dataclasses.replace(self._teacher_opts, flat_frac=frac),
                bg_color=bg)
            imgs.append(out["image"])
            deps.append(out["depth"])
        return (torch.cat(imgs)[inv].reshape(h, w, 3),
                torch.cat(deps)[inv].reshape(h, w))

    def proxy_datasets(self) -> float:
        """Replace the attached dataset's ground truth with teacher renders;
        returns the seconds it took. Two phases with one host sync each:
        every view-chunk's march demand (which picks, per chunk, skip / a
        covering flat_frac / the grid branch), then every view's render."""
        t0 = time.time()
        h, w = self.dataset.h, self.dataset.w
        chunk = min(self.cfg.eval_chunk, h * w)
        fracs_per_view = None
        if self.opts.compaction == "topk":
            demands = []
            for pose in self.dataset.poses:
                ro_c, rd_c, _ = self._teacher_view_setup(pose, h, w, chunk)
                demands.append(torch.stack([
                    self._teacher_demand(self.teacher_bitfield, ro_c[ci],
                                         rd_c[ci])
                    for ci in range(ro_c.shape[0])]))
            demands = torch.stack(demands).cpu().numpy()  # the one sync
            fracs_per_view = [[self._covering_frac(float(d), chunk)
                               for d in row] for row in demands]
            fracs = [f for row in fracs_per_view for f in row]
            self.proxy_stats = {
                "views": len(fracs_per_view),
                "chunks_skipped": sum(f == 0.0 for f in fracs),
                "chunks_grid": sum(f is None for f in fracs),
                "chunks_packed": sum(bool(f) for f in fracs)}
        views = iter(range(len(self.dataset)))
        ds = proxy_dataset(
            self.dataset,
            lambda p: self.render_teacher_view(
                p, fracs=(fracs_per_view[next(views)]
                          if fracs_per_view is not None else None)))
        self.attach_dataset(ds)
        return time.time() - t0

    # --------------------------------------------------------------- stage 1

    @torch.no_grad()
    def _teacher_query(self, points: torch.Tensor, dirs: torch.Tensor,
                       qchunk: int = 2**18):
        """(sigma [P], colour [P, 3]) of the frozen teacher's own field at
        device tensors, in chunks, with no host sync."""
        outs = [self.field.apply(self.teacher_params, self.fcfg,
                                 points[i:i + qchunk], dirs[i:i + qchunk])
                for i in range(0, points.shape[0], qchunk)]
        if not outs:
            return points.new_zeros((0,)), points.new_zeros((0, 3))
        return (torch.cat([s for s, _ in outs]),
                torch.cat([c for _, c in outs]))

    def _edit_mask(self, pts: np.ndarray):
        """map_to_origin over host points with a probe direction ->
        (mapped points, mapped dirs, mask) device tensors."""
        p = torch.from_numpy(pts).to(self.device)
        probe = torch.tensor([1.0, 0.0, 0.0], device=self.device) \
            .expand(p.shape)
        return map_to_origin(self.mapper, p, probe)

    @torch.no_grad()
    def init_pretraining(self, pcfg: PretrainConfig):
        """Sample the three point shells and cache the teacher's ground
        truth for them. Shell directions are drawn on the host from
        numpy's default_rng(0) (local) and (1) (the outside shells)."""
        self.pcfg = pcfg
        dev = self.device
        b = self.opts.bound
        aabb = np.array([[-b] * 3, [b] * 3], np.float32)
        data = {}

        # local: inside the edit region, mapped back to the source
        if pcfg.local_point_step > 0:
            pts, dir_set = sample_grid_points(self.mapper.force_fill_bound,
                                              pcfg.local_point_step,
                                              pcfg.local_angle_step)
            mpts, mdirs, mask = self._edit_mask(pts)
            if "map_source" in self.mapper.flags:
                mask = torch.ones_like(mask)
            keep = torch.nonzero(mask)[:, 0]
            n_keep = int(keep.shape[0])
            rng = np.random.default_rng(0)
            dirs_k = dir_set[rng.integers(0, len(dir_set), n_keep)]
            mpts_k, mdirs_k = mpts[keep], mdirs[keep]
            gt_sigma, gt_color = self._teacher_query(mpts_k, mdirs_k)
            gt_color = map_color(self.mapper, mpts_k, mdirs_k, gt_color)
            data["local"] = dict(
                points=torch.from_numpy(pts).to(dev)[keep],
                dirs=torch.from_numpy(dirs_k).to(dev),
                sigma=gt_sigma, color=gt_color)

        # surrounding: the extended bounds minus the edit region
        if pcfg.surrounding_point_step > 0:
            sb = np.array(self.mapper.force_fill_bound, np.float32) \
                .reshape(-1, 2, 3).copy()
            sb[:, 0] = np.maximum(sb[:, 0] - pcfg.surrounding_bounds_extend,
                                  aabb[0])
            sb[:, 1] = np.minimum(sb[:, 1] + pcfg.surrounding_bounds_extend,
                                  aabb[1])
            data["surrounding"] = self._outside_shell(
                sb, pcfg.surrounding_point_step, pcfg.surrounding_angle_step)

        # global: the whole scene box minus the edit region
        if pcfg.global_point_step > 0:
            data["global"] = self._outside_shell(
                aabb[None], pcfg.global_point_step, pcfg.global_angle_step)

        # pad every shell to a whole number of batches: [n_batches, bs, ...];
        # padding rows repeat row 0 at weight 0
        bs = pcfg.batch_size
        self.pretrain_data = {}
        for k, v in data.items():
            n = v["points"].shape[0]
            if n == 0:
                continue
            pad = (-n) % bs
            nb = (n + pad) // bs
            idx = torch.cat([torch.arange(n, device=dev),
                             torch.zeros(pad, dtype=torch.int64, device=dev)])
            wgt = torch.cat([torch.ones(n, device=dev),
                             torch.zeros(pad, device=dev)])
            self.pretrain_data[k] = {
                "points": v["points"][idx].reshape(nb, bs, 3),
                "dirs": v["dirs"][idx].reshape(nb, bs, 3),
                "sigma": v["sigma"][idx].reshape(nb, bs),
                "color": v["color"][idx].reshape(nb, bs, 3),
                "weight": wgt.reshape(nb, bs),
                "n_batches": nb,
            }
        self.is_pretraining = True
        if self.state is None:
            self.init_state()
        # the family's pretraining leaves, Adam at a constant learning rate
        # (no decay: the schedule's horizon is infinite); the others get no
        # update
        self._pre_opt = Optimizer(pcfg.lr, math.inf)
        self._pre_opt_state = self._pre_opt.init(
            _pretrain_leaves(self.state.params))
        if pcfg.export_debug and self.cfg.workspace:
            vis = os.path.join(self.cfg.workspace, "pretrain_vis")
            os.makedirs(vis, exist_ok=True)
            for k, v in data.items():
                geo.export_ply_points(os.path.join(vis, f"{k}.ply"),
                                      v["points"].cpu().numpy(),
                                      v["color"].cpu().numpy())

    def _outside_shell(self, bounds, step, angle_step) -> dict:
        pts, dir_set = sample_grid_points(bounds, step, angle_step)
        _, _, mask = self._edit_mask(pts)
        keep = torch.nonzero(~mask)[:, 0]
        rng = np.random.default_rng(1)
        dirs_k = dir_set[rng.integers(0, len(dir_set), int(keep.shape[0]))]
        pts_k = torch.from_numpy(pts).to(self.device)[keep]
        dirs_k = torch.from_numpy(dirs_k).to(self.device)
        sigma, color = self._teacher_query(pts_k, dirs_k)
        return dict(points=pts_k, dirs=dirs_k, sigma=sigma, color=color)

    def pretrain_loss(self, params, batch: dict) -> torch.Tensor:
        """Weighted L1 of one shell batch: |log1p sigma - log1p gt| (or raw
        sigma) plus the colour error, each a mean over the weight."""
        sigma, color = self.field.apply(params, self.fcfg, batch["points"],
                                        batch["dirs"])
        w = batch["weight"]
        wsum = w.sum().clamp(min=1e-6)
        if self.pcfg.sigma_log_space:
            diff = (torch.log1p(sigma) - torch.log1p(batch["sigma"])).abs()
        else:
            diff = (sigma - batch["sigma"]).abs()
        sl = (diff * w).sum() / wsum
        cl = ((color - batch["color"]).abs() * w[:, None]).sum() / (3 * wsum)
        return sl + cl

    def _pretrain_step(self, batch: dict) -> torch.Tensor:
        """One pretrain batch: loss, gradients of the pretraining leaves,
        Adam on them, EMA over every leaf. Returns the loss (a device
        tensor)."""
        st = self.state
        moved = _pretrain_leaves(st.params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in ckpt_io.flatten_tree(moved)}
        loss = self.pretrain_loss(
            {**st.params, **ckpt_io.map_tree(moved, lambda k, _: leaves[k])},
            batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        with torch.no_grad():
            updates, self._pre_opt_state = self._pre_opt.update(
                ckpt_io.map_tree(moved, lambda k, _: grads[k]),
                self._pre_opt_state)
            params = {**st.params, **apply_updates(moved, updates)}
            d = self.cfg.ema_decay
            ema = ckpt_io.map_trees(lambda e, p: e * d + p * (1.0 - d),
                                    st.ema_params, params)
        self.state = st._replace(params=params, ema_params=ema)
        return loss.detach()

    def _hack_student_bitfield(self):
        """The student's bitfield must include the (empty) edit region."""
        occ = self.state.occ
        self.state = self.state._replace(occ=occ._replace(
            bitfield=hack_bitfield(occ.bitfield, self._hack_bytes,
                                   self._hack_masks)))

    def _shell_losses(self):
        """One pass over every cached shell -> a list of [n_batches] loss
        tensors, one per shell."""
        return [torch.stack([self._pretrain_step({k: src[k][b]
                                                  for k in _BATCH_KEYS})
                             for b in range(src["n_batches"])])
                for src in self.pretrain_data.values()]

    def pretrain_one_epoch(self) -> float:
        """One pass over all cached shells; the mean batch loss."""
        self._hack_student_bitfield()
        return float(torch.cat(self._shell_losses()).mean())

    def pretrain_epochs(self, n_epochs: int) -> np.ndarray:
        """`n_epochs` shell passes with one host sync at the end -> the
        per-epoch losses [n_epochs] (the mean over shells of each shell's
        mean batch loss)."""
        self._hack_student_bitfield()
        losses = [torch.stack([ls.mean() for ls in self._shell_losses()]).mean()
                  for _ in range(n_epochs)]
        return torch.stack(losses).cpu().numpy()

    # --------------------------------------------------------------- stage 2

    def _apply_hack(self):
        """Force-fill the edit region in the student's bitfield and widen
        the march AABB to it."""
        occ = self.state.occ
        aabb = torch.cat([torch.minimum(occ.occ_aabb[:3], self._hack_aabb[:3]),
                          torch.maximum(occ.occ_aabb[3:], self._hack_aabb[3:])])
        self.state = self.state._replace(occ=occ._replace(
            bitfield=hack_bitfield(occ.bitfield, self._hack_bytes,
                                   self._hack_masks),
            occ_aabb=aabb))

    def update_grid_hacked(self, full: bool = False):
        """Occupancy refresh, then the hack again: the (initially empty)
        edit region stays inside the candidate ladders."""
        self.update_grid(full=full)
        self._apply_hack()

    def _grid_update_fns(self):
        return (lambda: self.update_grid_hacked(full=True),
                lambda: self.update_grid_hacked(full=False))

    def start_finetune(self):
        """Stage 2's set-up before its first step (after `proxy_datasets`):
        a fresh optimizer state over every leaf, a full hacked occupancy
        refresh and, under the adaptive budget, a march probe and a
        retune."""
        self.state = self.state._replace(
            opt_state=self.optimizer.init(self.state.params))
        # warm start: the occupancy is sharp, so the budget retune can fire
        # at the first measured boundary
        self.cfg.retune_warm = True
        self.update_grid_hacked(full=True)
        # the hacked bitfield inflates the sample demand well above the
        # default bucket: measure it by a march and retune before the first
        # step
        if self.cfg.adaptive_budget and self.opts.compaction == "topk":
            self._seed_mean_count_probe()
            self._retune_budget()

    def restore_grid(self):
        """Drop the force-fill once the edit is distilled: one full
        occupancy refresh against the student's own density, which now
        covers the edit region, with no hack applied. Without it later
        renders march the inflated bitfield."""
        self.update_grid(full=True)

    def train_edit(self, pcfg: PretrainConfig, finetune_steps: int = 1500,
                   pretrain_epochs: Optional[int] = None, proxy: bool = True,
                   log: bool = True) -> dict:
        """The full two-stage edit; returns the timer dict (also written to
        `<workspace>/timer.json`)."""
        if self.state is None:
            self.init_state()
        # the student starts from the teacher's weights
        self.state = self.state._replace(
            params=ckpt_io.map_tree(self.teacher_params,
                                    lambda _, t: t.clone()),
            ema_params=ckpt_io.map_tree(self.teacher_params,
                                        lambda _, t: t.clone()))
        self._dump_run_config(pcfg)

        t0 = time.time()
        self.init_pretraining(pcfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_init = time.time() - t0

        epochs = pcfg.epochs if pretrain_epochs is None else pretrain_epochs
        e = 0
        while e < epochs:  # blocks of <= 10 epochs: one loss sync per block
            n = min(10, epochs - e)
            t0 = time.time()
            losses = self.pretrain_epochs(n)
            self.time_inspector["pretraining"].extend(
                [(time.time() - t0) / n] * n)
            self.pretrain_losses.extend(float(v) for v in losses)
            if log:
                self._log(f"[pretrain] epochs {e}-{e + n - 1} "
                          f"loss={float(losses[-1]):.5f}")
            e += n
        self.is_pretraining = False

        t_proxy = 0.0
        if proxy and finetune_steps > 0:
            t_proxy = self.proxy_datasets()

        if finetune_steps > 0:
            t0 = time.time()
            self.start_finetune()
            self.train(steps=finetune_steps)
            self.time_inspector["training"].append(time.time() - t0)
            # the edit is baked in: march the real density from here on
            self.restore_grid()

        pre, trn = (self.time_inspector[k] for k in ("pretraining", "training"))
        timer = {
            "pretraining": pre,
            "pretraining_avg": float(np.mean(pre)) if pre else 0.0,
            "pretraining_total": float(np.sum(pre)),
            "training": trn,
            "training_avg": float(np.mean(trn)) if trn else 0.0,
            "training_total": float(np.sum(trn)),
            "proxy_dataset": t_proxy,
            "pretrain_init": t_init,
        }
        if self.cfg.workspace:
            os.makedirs(self.cfg.workspace, exist_ok=True)
            with open(os.path.join(self.cfg.workspace, "timer.json"), "w") as f:
                json.dump(timer, f, indent=1)
        return timer

    def _dump_run_config(self, pcfg: PretrainConfig):
        """Reproducibility dump: seal.json, options.json, run.sh."""
        ws = self.cfg.workspace
        if not ws:
            return
        os.makedirs(ws, exist_ok=True)
        with open(os.path.join(ws, "seal.json"), "w") as f:
            json.dump(self.mapper.config, f, indent=1, default=str)
        with open(os.path.join(ws, "options.json"), "w") as f:
            json.dump({"opts": asdict(self.opts), "train": asdict(self.cfg),
                       "pretrain": asdict(pcfg)}, f, indent=1, default=str)
        with open(os.path.join(ws, "run.sh"), "w") as f:
            f.write("python " + " ".join(sys.argv) + "\n")
