"""Trainer state and full-image rendering (port of the render half of
seal3d_tpu/train/trainer.py).

The Trainer holds a `TrainState` (params, EMA params, occupancy, step) and
offers what the render ("serve") path needs: `init_state` (random init,
occupancy init, `mark_untrained`), the full grid update, checkpoint load and
save, and `render_image` with Morton-ordered chunks, the closed-form demand
probe, per-chunk flat_frac buckets and zero-demand chunk skipping. PyTorch
runs eagerly, so nothing here is jitted; the per-chunk buckets only size the
packed buffers. The train step, Adam and EMA belong to the training slice.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from seal3d_tpu_torch.data.rays import get_full_rays
from seal3d_tpu_torch.ops.raymarch import group_plan, occupancy_at
from seal3d_tpu_torch.render.occupancy import (OccupancyState, mark_untrained,
                                               occupancy_init,
                                               occupancy_update)
from seal3d_tpu_torch.render.renderer import RenderOptions, render_rays
from seal3d_tpu_torch.train import checkpoint as ckpt_io


@dataclass
class TrainConfig:
    """The reference's TrainConfig: same fields and defaults (see its
    comments for each)."""

    lr: float = 1e-2
    max_steps: int = 30000
    num_rays: int = 4096
    ema_decay: float = 0.95
    update_grid_interval: int = 16
    full_grid_updates: int = 16
    density_thresh: float = 10.0
    eval_chunk: int = 8192
    eval_budget_per_ray: int = 192
    eval_flat_frac: Optional[float] = None
    eval_two_level: bool = True
    eval_tl_over: float = 2.5
    eval_coarse_steps: int = 32
    eval_tl_kg: int = -1
    eval_tl_group: int = 4
    eval_tl_pool: int = 64
    eval_adaptive: bool = True
    eval_buckets: tuple = (0.0625, 0.125, 0.1875, 0.25, 0.375, 0.5,
                           0.625, 0.75, 1.0)
    eval_tile_chunks: bool = True
    random_bg: bool = True
    error_map: bool = False
    adaptive_budget: bool = False
    budget_buckets: tuple = (0.25, 0.375, 0.5, 0.625, 0.75, 1.0)
    retune_warm: bool = False
    color_space: str = "srgb"
    rand_pose: int = -1
    clip_size: int = 128
    clip_pose_radius: float = 2.2
    lr_net_scale: float = 1.0
    max_keep_ckpt: int = 2
    workspace: Optional[str] = None


class TrainState(NamedTuple):
    """Checkpointed state; field names give the reference's `.npz` keys."""

    params: Any
    ema_params: Any
    occ: OccupancyState
    step: torch.Tensor


class Trainer:
    """Owns the state of one field and renders it."""

    def __init__(self, field_mod, field_cfg, opts: RenderOptions,
                 cfg: TrainConfig, dataset=None, seed: int = 0, device=None):
        self.field = field_mod
        self.fcfg = field_cfg
        self.opts = opts
        self.cfg = cfg
        self.device = torch.device(device if device is not None else "cpu")
        # params are drawn on the CPU (same numbers on every device); the
        # occupancy jitter on the device itself
        self.init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.state: Optional[TrainState] = None
        self.dataset = None
        # one dict per render_image call (seconds, chunks, buckets, samples,
        # non-finite output values)
        self.render_stats = []
        if dataset is not None:
            self.attach_dataset(dataset)

        eval_opts = dataclasses.replace(
            opts, budget_per_ray=cfg.eval_budget_per_ray,
            flat_frac=cfg.eval_flat_frac, composite_seg="scan")
        if cfg.eval_two_level:
            eval_opts = dataclasses.replace(
                eval_opts, march_two_level=True, tl_over=cfg.eval_tl_over,
                tl_kg=cfg.eval_tl_kg,
                tl_group=cfg.eval_tl_group or opts.tl_group,
                tl_pool=cfg.eval_tl_pool or opts.tl_pool,
                coarse_steps=cfg.eval_coarse_steps if opts.coarse_steps else 0,
                tl_kernel=opts.tl_kernel)
        self.eval_opts = eval_opts
        self._eval_tl_uncapped = (eval_opts.two_level_ok(cfg.eval_budget_per_ray)
                                  and eval_opts.tl_kg == -1)
        self._adaptive = (cfg.eval_adaptive and cfg.eval_flat_frac is not None
                          and opts.compaction == "topk")

    # ------------------------------------------------------------------ setup

    def attach_dataset(self, dataset):
        self.dataset = dataset
        self._poses = torch.as_tensor(dataset.poses, dtype=torch.float32,
                                      device=self.device)
        self._intrinsics = torch.as_tensor(dataset.intrinsics,
                                           dtype=torch.float32,
                                           device=self.device)

    def init_state(self) -> TrainState:
        params = self.field.init(self.fcfg, generator=self.init_generator)
        params = ckpt_io.map_tree(params, lambda _, t: t.to(self.device))
        ema = ckpt_io.map_tree(params, lambda _, t: t.clone())
        occ = occupancy_init(self.opts.cascades, device=self.device)
        if self.dataset is not None:
            occ = mark_untrained(occ, self._poses, self._intrinsics,
                                 self.opts.bound)
        self.state = TrainState(params=params, ema_params=ema, occ=occ,
                                step=torch.zeros((), dtype=torch.int32,
                                                 device=self.device))
        return self.state

    @torch.no_grad()
    def update_grid(self, jitter: Optional[torch.Tensor] = None
                    ) -> OccupancyState:
        """One full occupancy refresh through the field's density (the
        current params, as in the reference's train loop)."""
        params, fcfg, scale = self.state.params, self.fcfg, self.opts.density_scale

        def density_fn(x):
            return self.field.density(params, fcfg, x)["sigma"] * scale

        occ = occupancy_update(self.state.occ, density_fn, self.opts.bound,
                               density_thresh=self.cfg.density_thresh,
                               jitter=jitter, generator=self.generator)
        self.state = self.state._replace(occ=occ)
        return occ

    def _march_aabb(self, occ_aabb: torch.Tensor) -> torch.Tensor:
        """Occupied-cell AABB intersected with the scene box."""
        scene = torch.tensor(self.opts.aabb, dtype=torch.float32,
                             device=occ_aabb.device)
        return torch.cat([torch.maximum(occ_aabb[:3], scene[:3]),
                          torch.minimum(occ_aabb[3:], scene[3:])])

    # ---------------------------------------------------------- checkpoints

    def save_checkpoint(self, path: str) -> str:
        ckpt_io.save_state(path, self.state)
        return path

    def load_checkpoint(self, path: str) -> TrainState:
        if self.state is None:
            self.init_state()
        self.state = ckpt_io.load_state(path, self.state)
        return self.state

    # ------------------------------------------------------------- rendering

    def _chunk_layout(self, h: int, w: int, chunk: int):
        """Pixel -> chunk-slot layout: (sel [n_chunks, chunk] pixel index or
        -1 for pad, nv [n_chunks] valid slots, inv [h*w] inverse permutation).
        With eval_tile_chunks, pixels go in Z-order (Morton) so a chunk is a
        compact 2-D blob; pads sit at the tail."""
        mode = bool(self.cfg.eval_tile_chunks)
        key = (h, w, chunk, mode)
        cache = getattr(self, "_chunk_layout_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        n = h * w
        n_chunks = -(-n // chunk)
        if mode and n > chunk:
            rr, cc = np.meshgrid(np.arange(h, dtype=np.int64),
                                 np.arange(w, dtype=np.int64), indexing="ij")

            def _spread(v):  # interleave-ready bit spread (16 -> 32 bits)
                v = (v | (v << 8)) & 0x00FF00FF
                v = (v | (v << 4)) & 0x0F0F0F0F
                v = (v | (v << 2)) & 0x33333333
                v = (v | (v << 1)) & 0x55555555
                return v

            code = _spread(rr) | (_spread(cc) << 1)
            order = np.argsort(code.reshape(-1), kind="stable")
        else:
            order = np.arange(n, dtype=np.int64)
        sel = np.concatenate([order, np.full(n_chunks * chunk - n, -1,
                                             np.int64)]).reshape(n_chunks, chunk)
        nv = (sel >= 0).sum(1).astype(np.int32)
        flat = sel.reshape(-1)
        inv = np.empty(n, np.int64)
        inv[flat[flat >= 0]] = np.nonzero(flat >= 0)[0]
        out = (sel, nv, inv)
        self._chunk_layout_cache = (key, out)
        return out

    def _eval_demand(self, bitfield, rays_o, rays_d, occ_aabb,
                     n_valid: int) -> torch.Tensor:
        """[2] int64 (fine sample demand, kept-group demand) of one chunk,
        pad rays at index >= n_valid masked out. Closed form at group
        granularity: occupied group reps x members inside the tightened
        interval, an upper bound of the fine repack's kept members."""
        eo = self.eval_opts
        if not (self._eval_tl_uncapped and eo.occ_stride == eo.tl_group
                and eo.coarse_steps > 0):
            raise NotImplementedError(
                "only the closed-form two-level demand probe is ported: "
                "ROADMAP.md Queue 1, '1l eval'")
        g = eo.tl_group
        plan = group_plan(rays_o, rays_d, bitfield, bound=eo.bound,
                          cascades=eo.cascades, max_steps=eo.max_steps,
                          k=self.cfg.eval_budget_per_ray,
                          num_candidates=eo.num_candidates, group=g,
                          min_near=eo.min_near, aabb=self._march_aabb(occ_aabb),
                          coarse_steps=eo.coarse_steps, kg=-1, pool=eo.tl_pool)
        gi = torch.arange(eo.num_candidates // g, dtype=torch.float32,
                          device=rays_o.device)
        tr_ = plan.t0[:, None] + gi[None, :] * (g * plan.dt_min)
        xyz = rays_o[:, None, :] + tr_[..., None] * rays_d[:, None, :]
        occ_f = occupancy_at(xyz, torch.full_like(tr_, plan.dt_min), bitfield,
                             eo.cascades, eo.bound)
        n_cand = ((plan.fars - plan.t0) / plan.dt_min).clamp(min=0.0)
        members = (n_cand[:, None] - gi[None, :] * g).clamp(0.0, float(g))
        rok = (torch.arange(rays_o.shape[0], device=rays_o.device)
               < n_valid)[:, None]
        cnt = torch.where(plan.keep & occ_f & rok, torch.ceil(members), 0.0)
        return torch.stack([cnt.sum().to(torch.int64),
                            (plan.keep & rok).sum()])

    def _pick_bucket(self, chunk: int, fine: int, grp: int) -> float:
        """Smallest eval bucket whose fine budget covers the chunk's demand
        (x1.02 for the round-to-128) and whose group budget covers its kept
        groups, capped at eval_flat_frac."""
        ek = self.cfg.eval_budget_per_ray
        g = self.eval_opts.tl_group
        pick = 1.0
        for b in self.cfg.eval_buckets:
            budget = max(int(round(chunk * ek * b / 128)) * 128, 128)
            if budget < fine * 1.02:
                continue
            if self._eval_tl_uncapped:
                budget_g = max(-(-int(round(budget * self.eval_opts.tl_over))
                                 // (g * 16)) * 16, 16)
                if budget_g < grp:
                    continue
            pick = b
            break
        return min(pick, self.cfg.eval_flat_frac)

    @torch.no_grad()
    def render_image(self, pose, h: int, w: int, bg_color: float = 1.0):
        """Full-image render of the EMA params -> (image [h, w, 3], depth
        [h, w]) tensors, with a stats dict appended to `self.render_stats`."""
        t_start = time.perf_counter()
        chunk = self.cfg.eval_chunk
        st = self.state
        params = st.ema_params
        dev = self.device
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        rays = get_full_rays(pose, self._intrinsics, h, w)
        sel, nv, inv = self._chunk_layout(h, w, chunk)
        n_chunks = sel.shape[0]
        selt = torch.from_numpy(np.clip(sel, 0, None)).to(dev)
        slot_ok = torch.from_numpy(sel >= 0).to(dev)[..., None]
        # pad slots get rays that miss the scene AABB: zero demand
        b = self.opts.bound
        ro_c = torch.where(slot_ok, rays["rays_o"][selt],
                           torch.tensor([3.0 * b, 0.0, 0.0], device=dev))
        rd_c = torch.where(slot_ok, rays["rays_d"][selt],
                           torch.tensor([1.0, 0.0, 0.0], device=dev))
        aabb = self._march_aabb(st.occ.occ_aabb)

        buckets = [self.cfg.eval_flat_frac] * n_chunks
        skip = [False] * n_chunks
        if self._adaptive:
            # all chunks' demands, then ONE device -> host copy
            cnts = torch.stack([
                self._eval_demand(st.occ.bitfield, ro_c[ci], rd_c[ci],
                                  st.occ.occ_aabb, int(nv[ci]))
                for ci in range(n_chunks)]).cpu().numpy()
            for ci in range(n_chunks):
                fine, grp = int(cnts[ci, 0]), int(cnts[ci, 1])
                if fine == 0:  # no background net: renders to exactly bg
                    skip[ci] = True
                else:
                    buckets[ci] = self._pick_bucket(chunk, fine, grp)

        bg = torch.full((chunk, 3), bg_color, dtype=torch.float32, device=dev)
        imgs, deps, samples = [], [], []
        for ci in range(n_chunks):
            if skip[ci]:
                imgs.append(bg)
                deps.append(torch.zeros((chunk,), dtype=torch.float32,
                                        device=dev))
                continue
            opts = dataclasses.replace(self.eval_opts, flat_frac=buckets[ci])
            out = render_rays(params, self.field, self.fcfg, st.occ.bitfield,
                              ro_c[ci], rd_c[ci], opts, bg_color=bg, aabb=aabb)
            imgs.append(out["image"])
            deps.append(out["depth"])
            samples.append(out["num_samples"])
        invt = torch.from_numpy(inv).to(dev)
        image = torch.cat(imgs)[invt].reshape(h, w, 3)
        depth = torch.cat(deps)[invt].reshape(h, w)
        n_samples = int(torch.stack(samples).sum()) if samples else 0
        nonfinite = int((~torch.isfinite(image)).sum()
                        + (~torch.isfinite(depth)).sum())
        self.render_stats.append({
            "seconds": time.perf_counter() - t_start,
            "chunks_rendered": n_chunks - sum(skip),
            "chunks_skipped": sum(skip),
            "buckets": dict(collections.Counter(
                b for b, s in zip(buckets, skip) if not s)),
            "samples": n_samples,
            "nonfinite": nonfinite,
        })
        return image, depth
