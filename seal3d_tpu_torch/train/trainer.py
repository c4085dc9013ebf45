"""Trainer: train state, the train loop and full-image rendering (port of
seal3d_tpu/train/trainer.py).

The Trainer holds a `TrainState` (params, optimizer state, EMA params,
occupancy, step). `train_step` samples a ray batch, renders it, takes the
MSE loss and its gradient, and applies Adam (train/optim.py), the EMA and
the `mean_count` EMA; `train` runs steps with a grid update every 16 (the
first 16 full, then partial) and the adaptive budget's retunes;
`render_image` renders with Morton-ordered chunks, the demand probe (closed
form for the two-level march, a candidate count for the single-level one),
per-chunk flat_frac buckets and zero-demand chunk skipping; `evaluate`
scores a split and keeps the best checkpoint. With `use_dense` the loss,
`evaluate` and `render_image` go through the dense oracle
(`render_rays_dense`) and the train loop keeps no occupancy grid. With
`error_map` the state carries a 128x128 error map per training view: a step
draws its pixels in proportion to it and refreshes the cells it drew with
an EMA of their per-ray error. With a CLIP loss and `rand_pose` >= 0,
`clip_step` renders a random orbit pose and pulls it toward a text prompt
(every step at 0, else one guided step per `rand_pose` steps).

Under a mesh (`Trainer(mesh=...)`, parallel/mesh.py) each rank draws the same
global `StepRandom`, trains on its contiguous slice of the batch with its own
flat pack (`pack_shards` = the data axis' size, the single-level march), and
sums the gradients, the loss and the sample count over 'data' in one
collective before Adam; the error map is refreshed from every rank's
per-ray errors. With `grid_shard_levels` under a 'model' axis, each rank
holds its level shard of the grids and their Adam moments, and checkpoints
put the tables back together. Rank 0 alone writes checkpoints and the log.

PyTorch runs eagerly, so nothing is jitted: the reference's per-bucket jit
caches and blocked (scanned) steps have no counterpart, and the per-chunk
buckets only size the packed buffers. The step's random numbers (image,
pixels, background, march jitter, or the dense oracle's sample jitter and
importance uniforms) are a `StepRandom`, drawn from the trainer's device
generator or handed in by a test.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from seal3d_tpu_torch.data.provider import rand_poses
from seal3d_tpu_torch.data.rays import (ERROR_MAP_RES, error_map_cells,
                                        error_map_inds, get_full_rays,
                                        get_rays)
from seal3d_tpu_torch.ops.ladder import pack_tables
from seal3d_tpu_torch.ops.raymarch import (group_plan, ladder_plan_kernel,
                                           march_candidates, march_rays_grid,
                                           occupancy_at, ray_stride_keep)
from seal3d_tpu_torch.parallel import mesh as pmesh
from seal3d_tpu_torch.render.occupancy import (OccupancyState, mark_untrained,
                                               occupancy_init,
                                               occupancy_update)
from seal3d_tpu_torch.render.renderer import (RenderOptions, flat_budget,
                                             render_rays, render_rays_dense)
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.metrics import PerceptualMeter, PSNRMeter
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates
from seal3d_tpu_torch.utils.color import srgb_to_linear
from seal3d_tpu_torch.utils.trace import span


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


# train steps before Trainer.train's timing window opens (first grid
# updates, allocator warm-up), as the reference's bench warms up 48 steps
TIMING_WARMUP = 48
# the params leaves that level-sharded tensor parallelism splits over 'model'
TP_LEAVES = ("encoder", "encoder_color")


class TrainState(NamedTuple):
    """Checkpointed state; field names and order give the reference's
    `.npz` keys (`error_map`: [views, 128*128] with cfg.error_map, else
    None and absent from the file)."""

    params: Any
    opt_state: Any
    ema_params: Any
    occ: OccupancyState
    step: torch.Tensor
    error_map: Optional[torch.Tensor] = None


class StepRandom(NamedTuple):
    """The random numbers of one train step; the reference draws them from
    `jax.random.split(key, 4)` (image, pixels, background, jitter; the dense
    oracle splits its z jitter and importance uniforms off the last)."""

    img_idx: torch.Tensor         # [] int64 training view
    inds: torch.Tensor            # [N] int64 flat pixel indices (uniform, or
                                  # drawn from the view's error map)
    bg: Optional[torch.Tensor]    # [N, 3] random background, None = white
    jitter: Optional[torch.Tensor]  # [N] march-start jitter in [0, 1)
    z_jitter: Optional[torch.Tensor] = None  # [N, num_steps] dense oracle
    pdf_u: Optional[torch.Tensor] = None     # [N, upsample_steps] dense
    reg_points: Optional[torch.Tensor] = None  # [4096, 3] D-NeRF sigma_reg


def refresh_error_map(error_map: torch.Tensor, img_idx: torch.Tensor,
                      cells: torch.Tensor, per_ray: torch.Tensor):
    """error_map [B, E] with view img_idx's cells set to 0.9 * old + 0.1 *
    the per-ray error of the ray that drew them. Where several rays drew one
    cell, the last of them sets it (the reference's scatter on the CPU); the
    winners are chosen explicitly, so the card gives the same map."""
    cur = error_map[img_idx]
    n, e = cells.shape[0], cur.shape[0]
    order = torch.arange(n, device=cells.device)
    last = torch.full((e,), -1, dtype=order.dtype,
                      device=cells.device).scatter_reduce_(0, cells, order,
                                                           "amax")
    # losers write into a dump slot past the row's end
    dst = torch.where(last[cells] == order, cells, e)
    new = torch.cat([cur, cur.new_zeros(1)]).scatter_(
        0, dst, cur[cells] * 0.9 + 0.1 * per_ray)[:e]
    return error_map.index_copy(0, img_idx.reshape(1), new[None])


class _Clock:
    """Marks on the device's timeline: CUDA events on a card (read with no
    host sync until `seconds`), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, a, b) -> float:
        if not self.cuda:
            return b - a
        b.synchronize()
        return a.elapsed_time(b) / 1e3


class Trainer:
    """Owns the state of one field: trains, evaluates and renders it."""

    def __init__(self, field_mod, field_cfg, opts: RenderOptions,
                 cfg: TrainConfig, dataset=None, seed: int = 0, device=None,
                 name: str = "ngp", use_dense: bool = False, reg_fn=None,
                 optimizer=None, clip_loss=None, mesh=None):
        """reg_fn: params -> [] tensor added to each step's loss (TensoRF's
        L1 density sparsity), or None; optimizer: an Optimizer-like object
        (`init`, `update`), by default Adam over every leaf at cfg.lr;
        clip_loss: a prepared utils.clip_guidance.CLIPLoss for the guided
        steps of cfg.rand_pose >= 0, or None (no guided step); mesh: the
        parallel.mesh.Mesh this rank trains on, or None; the trainer makes
        it the ambient mesh (None included) here and where its steps, grid
        updates and renders start, so that a trainer without a mesh never
        runs on another's. Under a mesh whose 'data' axis has n > 1 ranks the flat pack
        is split per rank (pack_shards = n) and the train march is
        single-level, as the reference derives them from its mesh."""
        self.field = field_mod
        self.fcfg = field_cfg
        self.mesh = mesh
        n_data = mesh.size("data") if mesh is not None else 1
        if n_data > 1 and opts.pack_shards == 1:
            opts = dataclasses.replace(opts, pack_shards=n_data,
                                       march_two_level=False)
        pmesh.set_mesh(mesh)
        grid = getattr(field_cfg, "grid", None)
        self._tp = (mesh is not None and mesh.size("model") > 1
                    and grid is not None and grid.shard_levels
                    and grid.backend in ("xla", "halo"))
        self.opts = opts
        self.cfg = cfg
        self.name = name
        self.use_dense = use_dense
        # None means the card; only an explicit "cpu" runs on the CPU
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device (pass device='cpu' to run the plain "
                "PyTorch versions on the CPU)")
        # params are drawn on the CPU (same numbers on every device); the
        # step and occupancy randomness on the device itself
        self.init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.reg_fn = reg_fn
        self.clip_loss = clip_loss
        self._clip_acc = 0      # gt steps since the last guided step
        self.optimizer = optimizer or Optimizer(cfg.lr, cfg.max_steps,
                                                net_scale=cfg.lr_net_scale)
        self.state: Optional[TrainState] = None
        self.dataset = None
        # one dict per render_image call (seconds, chunks, buckets, samples,
        # non-finite output values)
        self.render_stats = []
        # logged train steps {"step", "loss"} and evaluations {"step", "psnr",
        # "lpips_proxy"}; train_stats: the last train() call's timings
        self.history, self.eval_history, self.train_stats = [], [], {}
        self._logfile = None
        self.rank0 = mesh is None or torch.distributed.get_rank() == 0
        if cfg.workspace and self.rank0:
            os.makedirs(cfg.workspace, exist_ok=True)
            self._logfile = os.path.join(cfg.workspace, f"log_{name}.txt")
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
                          and opts.compaction == "topk" and not use_dense)

    # ------------------------------------------------------------------ setup

    def attach_dataset(self, dataset):
        self.dataset = dataset
        dev = self.device
        self._poses = torch.as_tensor(dataset.poses, dtype=torch.float32,
                                      device=dev)
        self._intrinsics = torch.as_tensor(dataset.intrinsics,
                                           dtype=torch.float32, device=dev)
        self._images = (None if dataset.images is None else
                        torch.as_tensor(dataset.images, device=dev))
        # teacher-proxied depths of a Seal dataset: the loss's depth term
        self._depths = (None if dataset.depths is None else
                        torch.as_tensor(dataset.depths, dtype=torch.float32,
                                        device=dev))

    def init_state(self) -> TrainState:
        params = self.field.init(self.fcfg, generator=self.init_generator)
        params = ckpt_io.map_tree(params, lambda _, t: t.to(self.device))
        if self._tp:
            params = self._shard_levels(params)
        if self.mesh is not None:
            params = pmesh.replicate(params, self.mesh, self._sharded)
        ema = ckpt_io.map_tree(params, lambda _, t: t.clone())
        occ = occupancy_init(self.opts.cascades, device=self.device)
        if self.dataset is not None and not self.use_dense:
            occ = mark_untrained(occ, self._poses, self._intrinsics,
                                 self.opts.bound)
        emap = None
        if self.cfg.error_map and self.dataset is not None:
            emap = torch.full((len(self.dataset), ERROR_MAP_RES**2), 0.1,
                              dtype=torch.float32, device=self.device)
        self.state = TrainState(params=params,
                                opt_state=self.optimizer.init(params),
                                ema_params=ema, occ=occ,
                                step=torch.zeros((), dtype=torch.int32,
                                                 device=self.device),
                                error_map=emap)
        return self.state

    # ------------------------------------------------------- mesh, sharding

    def _sharded(self, path: str) -> bool:
        """Whether the state leaf at `path` is a model rank's level shard."""
        return self._tp and path.rsplit("/", 1)[-1] in TP_LEAVES

    def _shard_levels(self, tree):
        """`tree` with its TP_LEAVES cut to this model rank's levels."""
        j, n = self.mesh.index("model"), self.mesh.size("model")
        return ckpt_io.map_tree(tree, lambda k, t: ckpt_io.level_shard(
            t, self.fcfg.grid, n, j) if self._sharded(k) else t)

    def full_state(self) -> TrainState:
        """The state with whole tables: under tensor parallelism the model
        ranks' level shards put back together (a collective over 'model'
        that every rank enters, outside the step); else the state itself."""
        if not self._tp:
            return self.state
        return ckpt_io.map_tree(self.state, lambda k, t: pmesh.gather_rows(
            t, self.mesh, "model", "checkpoint") if self._sharded(k) else t)

    @property
    def step_opts(self) -> RenderOptions:
        """The render options of this rank's part of a train step: under a
        mesh each rank packs its slice of the batch alone (pack_shards 1),
        into its share of the sharded pack's budget."""
        if self.mesh is None:
            return self.opts
        opts = dataclasses.replace(self.opts, pack_shards=1)
        n, shards = self.cfg.num_rays, self.opts.pack_shards
        if (opts.flat_frac is not None and opts.flat_frac < 1.0
                and flat_budget(n, self.opts)
                != shards * flat_budget(n // shards, opts)):
            raise ValueError(f"flat_frac {opts.flat_frac}: a rank's budget is "
                             f"not its share of the {shards}-shard pack's")
        return opts

    def reduce_step(self, loss, grads, num_samples):
        """(loss, grads, num_samples) of the global batch from this rank's:
        the gradients and the loss summed over 'data' and divided by its
        size (each rank's loss is the mean over its equal slice), the
        sample count summed, in one all_reduce. The MLP weights' gradients
        (the field's MLP_NETS) are left out: their casts' backwards summed
        each use's cotangent over 'data' before its bf16 rounding, as the
        reference does (models/mlp.py), so they arrive global. Under tensor
        parallelism the model ranks then take model rank 0's gradients of
        the replicated leaves (`_agree_over_model`). Unchanged without a
        mesh."""
        if self.mesh is None:
            return loss, grads, num_samples
        nets = getattr(self.field, "MLP_NETS", ())
        flat = [(k, g) for k, g in ckpt_io.flatten_tree(grads)
                if k.split("/", 1)[0] not in nets]
        buf = torch.cat([g.reshape(-1) for _, g in flat]
                        + [loss.reshape(1).to(torch.float32),
                           num_samples.reshape(1).to(torch.float32)])
        pmesh.collective("all_reduce", buf, self.mesh, "data", "grads")
        n = self.mesh.size("data")
        parts = dict(zip([k for k, _ in flat],
                         buf[:-2].split([g.numel() for _, g in flat])))
        grads = ckpt_io.map_tree(
            grads, lambda k, g: parts[k].reshape(g.shape) / n
            if k in parts else g)
        if self._tp:
            grads = self._agree_over_model(grads)
        return (buf[-2] / n, grads,
                buf[-1].round().to(num_samples.dtype))

    def _agree_over_model(self, grads):
        """grads with every leaf that is not a level shard replaced by model
        rank 0's, in one broadcast over 'model'. The model ranks compute
        those gradients each on the same rows, but the atomic sums of the
        composite's and K1's backwards differ between processes on the
        card, and replicas that took different steps would drift apart."""
        rep = [(k, g) for k, g in ckpt_io.flatten_tree(grads)
               if not self._sharded(k)]
        buf = torch.cat([g.reshape(-1) for _, g in rep])
        pmesh.collective("broadcast", buf, self.mesh, "model", "grads")
        parts = dict(zip([k for k, _ in rep],
                         buf.split([g.numel() for _, g in rep])))
        return ckpt_io.map_tree(grads, lambda k, g: parts[k].reshape(g.shape)
                                if k in parts else g)

    # ------------------------------------------------------------ train step

    def draw_step_random(self) -> StepRandom:
        """One step's random numbers from the trainer's device generator;
        with an error map the pixels are drawn from the view's row of it."""
        n, gen, dev = self.cfg.num_rays, self.generator, self.device
        ds = self.dataset
        img_idx = torch.randint(0, len(ds), (), generator=gen, device=dev)
        emap = self.state.error_map
        if emap is None:
            inds = torch.randint(0, ds.h * ds.w, (n,), generator=gen,
                                 device=dev)
        else:
            inds = error_map_inds(emap[img_idx], ds.h, ds.w, n, generator=gen)
        bg = None
        if self.cfg.random_bg and self._images.shape[-1] == 4:
            bg = torch.rand((n, 3), generator=gen, device=dev)
        if not self.use_dense:
            jitter = torch.rand((n,), generator=gen, device=dev)
            return StepRandom(img_idx=img_idx, inds=inds, bg=bg, jitter=jitter)
        opts = self.opts
        z_jitter = torch.rand((n, opts.num_steps), generator=gen, device=dev)
        pdf_u = (torch.rand((n, opts.upsample_steps), generator=gen,
                            device=dev) if opts.upsample_steps > 0 else None)
        return StepRandom(img_idx=img_idx, inds=inds, bg=bg, jitter=None,
                          z_jitter=z_jitter, pdf_u=pdf_u)

    def sample_batch(self, rand: StepRandom) -> dict:
        """Rays, ground truth and background of one step's pixels."""
        h, w, n = self.dataset.h, self.dataset.w, rand.inds.shape[0]
        rays = get_rays(self._poses[rand.img_idx], self._intrinsics, h, w, n,
                        inds=rand.inds)
        img = self._images[rand.img_idx].reshape(h * w, -1)
        gt = img[rand.inds].to(torch.float32) / 255.0
        if self.cfg.color_space == "linear":
            gt = torch.cat([srgb_to_linear(gt[:, :3]), gt[:, 3:]], -1)
        bg = rand.bg
        if bg is None:  # RGB ground truth keeps a white background
            bg = torch.ones((n, 3), dtype=torch.float32, device=gt.device)
        if gt.shape[-1] == 4:
            gt = gt[:, :3] * gt[:, 3:] + bg * (1.0 - gt[:, 3:])
        batch = {"rays_o": rays["rays_o"], "rays_d": rays["rays_d"],
                 "gt": gt, "bg": bg}
        for k in ("z_jitter", "pdf_u"):   # the dense oracle's draws
            if getattr(rand, k) is not None:
                batch[k] = getattr(rand, k)
        if self._depths is not None:
            batch["gt_depth"] = self._depths[rand.img_idx].reshape(-1)[rand.inds]
        return pmesh.shard_rays(batch, self.mesh)

    def loss_fn(self, params, occ: OccupancyState, batch: dict,
                jitter: Optional[torch.Tensor]):
        """(loss [], render dict with the detached `per_ray` loss) of one
        batch: the mean over rays of the
        MSE over RGB plus, where the batch carries `gt_depth` (a
        teacher-proxied Seal dataset), the squared depth error, plus
        `reg_fn(params)` where the trainer has one. With
        use_dense the batch's `z_jitter` and `pdf_u` perturb the dense
        oracle (drawn from the trainer's generator where None)."""
        if self.use_dense:
            out = render_rays_dense(
                params, self.field, self.fcfg, batch["rays_o"],
                batch["rays_d"], self.opts, bg_color=batch["bg"],
                perturb=True, z_jitter=batch.get("z_jitter"),
                pdf_u=batch.get("pdf_u"), generator=self.generator)
        else:
            out = render_rays(params, self.field, self.fcfg, occ.bitfield,
                              batch["rays_o"], batch["rays_d"], self.step_opts,
                              bg_color=batch["bg"],
                              aabb=self._march_aabb(occ.occ_aabb),
                              jitter=jitter)
        per_ray = ((out["image"] - batch["gt"]) ** 2).mean(-1)
        if "gt_depth" in batch:
            per_ray = per_ray + (out["depth"] - batch["gt_depth"]) ** 2
        loss = per_ray.mean()
        if self.reg_fn is not None:
            loss = loss + self.reg_fn(params)
        out["per_ray"] = per_ray.detach()
        return loss, out

    @staticmethod
    def _value_and_grads(params, fn):
        """(fn's loss, gradient tree shaped like params, fn's aux) of
        fn(params) -> (loss [], aux). A leaf no gradient reaches gets zeros
        (as jax.grad gives it): D-NeRF's deform net under the halo encode,
        which gives positions no gradient."""
        flat = ckpt_io.flatten_tree(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat}
        with span("step.forward"):
            loss, aux = fn(ckpt_io.map_tree(params, lambda k, _: leaves[k]))
        with span("step.backward"):
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in grads.items()}
        return loss.detach(), ckpt_io.map_tree(params, lambda k, _: grads[k]), aux

    def loss_and_grads(self, params, occ: OccupancyState, batch: dict,
                       jitter: Optional[torch.Tensor]):
        """(loss, gradient tree shaped like params, render dict)."""
        return self._value_and_grads(
            params, lambda p: self.loss_fn(p, occ, batch, jitter))

    @torch.no_grad()
    def _apply_grads(self, st: TrainState, grads) -> TrainState:
        """st after one optimizer update with grads, the EMA and step + 1."""
        with span("step.update"):
            updates, opt_state = self.optimizer.update(grads, st.opt_state)
            params = apply_updates(st.params, updates)
            d = self.cfg.ema_decay
            ema = ckpt_io.map_trees(lambda e, p: e * d + p * (1.0 - d),
                                    st.ema_params, params)
        return st._replace(params=params, opt_state=opt_state,
                           ema_params=ema, step=st.step + 1)

    def train_step(self, rand: Optional[StepRandom] = None) -> dict:
        """One step: batch, loss, gradient, Adam, EMA, mean_count EMA and,
        with an error map, its refresh at the drawn cells.
        Returns device tensors {"loss", "num_samples"} (no host sync). Its
        stages are `step.*` ranges in a torch.profiler trace."""
        st = self.state
        pmesh.set_mesh(self.mesh)
        if self.mesh is not None:
            self.mesh.reset_log()
        with span("step.batch"):
            rand = rand if rand is not None else self.draw_step_random()
            batch = self.sample_batch(rand)
        loss, grads, out = self.loss_and_grads(
            st.params, st.occ, batch, pmesh.shard_rays(rand.jitter, self.mesh))
        loss, grads, n_samples = self.reduce_step(loss, grads,
                                                  out["num_samples"])
        st = self._apply_grads(st, grads)
        with torch.no_grad():
            ns = n_samples.to(torch.float32)
            mc = st.occ.mean_count
            st = st._replace(occ=st.occ._replace(
                mean_count=torch.where(mc < 0, ns, mc * 0.9 + ns * 0.1)))
            if st.error_map is not None:
                per_ray = out["per_ray"]
                if self.mesh is not None:
                    per_ray = pmesh.gather_rows(per_ray, self.mesh, "data",
                                                "per_ray")
                cells = error_map_cells(rand.inds, self.dataset.h,
                                        self.dataset.w)
                st = st._replace(error_map=refresh_error_map(
                    st.error_map, rand.img_idx, cells, per_ray))
        self.state = st
        return {"loss": loss, "num_samples": n_samples}

    def clip_step(self) -> float:
        """One CLIP-guided step: render a random orbit pose (radius
        cfg.clip_pose_radius, polar angle 45-105 degrees, drawn from a numpy
        generator seeded by the step) at cfg.clip_size^2 with the dataset's
        focal length rescaled, through the [N, K] grid branch on a white
        background, and take one optimizer step on the CLIP loss's gradient,
        backpropagated through the render. Returns the CLIP loss."""
        if self.clip_loss is None or not self.clip_loss.available:
            raise RuntimeError("clip_step needs Trainer(clip_loss=) with a "
                               "prepared CLIPLoss")
        st, s = self.state, self.cfg.clip_size
        rng = np.random.default_rng(int(st.step) * 2 + 1)
        pose = rand_poses(rng, 1, radius=self.cfg.clip_pose_radius,
                          theta_range=(45, 105))[0]
        fx = float(self.dataset.intrinsics[0]) * (s / self.dataset.w)
        intr = torch.tensor([fx, fx, s / 2, s / 2], device=self.device)
        rays = get_full_rays(torch.as_tensor(pose, device=self.device), intr,
                             s, s)
        copts = dataclasses.replace(self.opts, flat_frac=None)

        def clip_loss(params):
            out = render_rays(params, self.field, self.fcfg, st.occ.bitfield,
                              rays["rays_o"], rays["rays_d"], copts,
                              bg_color=1.0,
                              aabb=self._march_aabb(st.occ.occ_aabb))
            return self.clip_loss.loss_torch(
                out["image"].reshape(s, s, 3)), None

        loss, grads, _ = self._value_and_grads(st.params, clip_loss)
        self.state = self._apply_grads(st, grads)
        return float(loss)

    # ------------------------------------------------------------ grid, loop

    @torch.no_grad()
    def update_grid(self, full: bool = True) -> OccupancyState:
        """One occupancy refresh (full or partial) through the field's
        density at the current params, as in the reference's train loop;
        its random numbers come from the trainer's generator."""
        pmesh.set_mesh(self.mesh)
        params, fcfg, scale = self.state.params, self.fcfg, self.opts.density_scale

        def density_fn(x):
            return self.field.density(params, fcfg, x)["sigma"] * scale

        occ = occupancy_update(self.state.occ, density_fn, self.opts.bound,
                               density_thresh=self.cfg.density_thresh,
                               full=full, generator=self.generator)
        self.state = self.state._replace(occ=occ)
        return occ

    def train(self, steps: Optional[int] = None,
              log_every: int = 500) -> dict:
        """Run `steps` train steps (default cfg.max_steps) with a grid update
        every update_grid_interval steps (none with use_dense: the dense
        oracle reads no occupancy grid). With a CLIP loss, cfg.rand_pose 0
        makes every step a guided `clip_step` and > 0 adds one after every
        rand_pose steps. The host reads the device only at loop entry, at
        logged steps, at each adaptive-budget retune and at guided steps.
        Fills `train_stats`: seconds of each grid update, and the wall time
        of the steps after the first TIMING_WARMUP (grid updates included).
        Returns the last logged {"loss": float}."""
        if self.state is None:
            self.init_state()
        cfg = self.cfg
        steps = steps if steps is not None else cfg.max_steps
        clock = _Clock(self.device)
        step_i = int(self.state.step)          # the one sync at loop entry
        iter_density = int(self.state.occ.iter_density)
        grid_marks, w0, last = [], None, {}
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            if not self.use_dense and step_i % cfg.update_grid_interval == 0:
                full = iter_density < cfg.full_grid_updates
                a = clock.mark()
                self._grid_update_fns()[0 if full else 1]()
                grid_marks.append((full, a, clock.mark()))
                iter_density += 1
                # from scratch, retuning waits out the full-update phase
                if cfg.adaptive_budget and (cfg.retune_warm or not full):
                    self._retune_budget()
            if i == TIMING_WARMUP + 1:
                w0 = clock.mark()
            guided = self.clip_loss is not None and cfg.rand_pose >= 0
            if guided and cfg.rand_pose == 0:
                metrics = {"loss": self.clip_step()}
            else:
                metrics = self.train_step()
            step_i += 1
            if guided and cfg.rand_pose > 0:
                self._clip_acc += 1
                while self._clip_acc >= cfg.rand_pose:
                    self._clip_acc -= cfg.rand_pose
                    self.clip_step()
                    step_i += 1
            if (i - 1) % log_every == 0 or i == steps:
                last = {"loss": float(metrics["loss"])}
                self.history.append({"step": step_i, **last})
                self._log(f"[train] step={step_i} loss={last['loss']:.5f} "
                          f"({i / (time.perf_counter() - t0):.1f} it/s)")
        end = clock.mark()
        self.train_stats = {
            "steps": steps,
            "grid_updates": [(full, clock.seconds(a, b))
                             for full, a, b in grid_marks],
            "window_steps": steps - TIMING_WARMUP if w0 is not None else 0,
            "window_s": clock.seconds(w0, end) if w0 is not None else 0.0,
        }
        return last

    def _grid_update_fns(self):
        """The (full, partial) occupancy refreshes the train loop runs;
        SealTrainer overrides them with refreshes that re-apply its bitfield
        hack."""
        return (lambda: self.update_grid(full=True),
                lambda: self.update_grid(full=False))

    @torch.no_grad()
    def _seed_mean_count_probe(self, n_views: int = 4):
        """Seed occ.mean_count with a march-only measurement: cfg.num_rays
        rays from each of a few dataset poses marched against the current
        bitfield at the train point, kept samples counted (no field, no
        step). A warm start can then pick its flat_frac bucket before the
        first train step. The pixels come from the trainer's generator."""
        st, opts = self.state, self.opts
        n = min(n_views, self._poses.shape[0])
        h, w = self.dataset.h, self.dataset.w
        total = []
        for i in range(n):
            rays = get_rays(self._poses[i * len(self.dataset) // n],
                            self._intrinsics, h, w, self.cfg.num_rays,
                            generator=self.generator)
            m = march_rays_grid(
                rays["rays_o"], rays["rays_d"], st.occ.bitfield, opts.bound,
                opts.cascades, opts.dt_gamma, opts.max_steps,
                opts.budget_per_ray, num_candidates=opts.num_candidates,
                min_near=opts.min_near,
                aabb=self._march_aabb(st.occ.occ_aabb),
                occ_stride=opts.occ_stride, coarse_steps=opts.coarse_steps)
            total.append(m.valid.sum())
        mean = torch.stack(total).sum().to(torch.float32) / n
        self.state = st._replace(occ=st.occ._replace(mean_count=mean))

    def _retune_budget(self):
        """Pick the flat_frac bucket matching the measured valid-sample
        occupancy (x1.15 headroom); None (the [N, K] grid branch) at 1.0."""
        mc = float(self.state.occ.mean_count)
        if mc <= 0 or self.opts.compaction != "topk":
            return
        cap = self.cfg.num_rays * self.opts.budget_per_ray
        frac = min(mc * 1.15 / cap, 1.0)
        bucket = next((b for b in self.cfg.budget_buckets if b >= frac), 1.0)
        target = None if bucket >= 1.0 else bucket
        if target != self.opts.flat_frac:
            self.opts = dataclasses.replace(self.opts, flat_frac=target)
            self._log(f"[budget] flat_frac -> {target} "
                      f"(mean_count={mc:.0f}/{cap})")

    def _log(self, msg: str):
        if not self.rank0:
            return
        print(msg)
        if self._logfile:
            with open(self._logfile, "a") as f:
                f.write(msg + "\n")

    def _march_aabb(self, occ_aabb: torch.Tensor) -> torch.Tensor:
        """Occupied-cell AABB intersected with the scene box."""
        scene = torch.tensor(self.opts.aabb, dtype=torch.float32,
                             device=occ_aabb.device)
        return torch.cat([torch.maximum(occ_aabb[:3], scene[:3]),
                          torch.minimum(occ_aabb[3:], scene[3:])])

    # ---------------------------------------------------------- checkpoints

    def save_checkpoint(self, path: Optional[str] = None,
                        full: bool = True) -> str:
        """Write the state (full: with the optimizer state) to `path`, by
        default `<workspace>/checkpoints/<name>_step<step:07d>.npz`, and
        keep the newest cfg.max_keep_ckpt step checkpoints. Under a mesh
        every rank calls it and rank 0 alone writes."""
        ws = self.cfg.workspace
        if path is None:
            if not ws:
                raise ValueError("save_checkpoint needs a path or a workspace")
            path = os.path.join(ws, "checkpoints",
                                f"{self.name}_step{int(self.state.step):07d}.npz")
        state = self.full_state()
        if not self.rank0:
            return path
        ckpt_io.save_state(path, state, full=full)
        if ws:
            ckpt_io.prune_checkpoints(os.path.join(ws, "checkpoints"),
                                      self.name, keep=self.cfg.max_keep_ckpt)
        return path

    def load_checkpoint(self, path: str) -> TrainState:
        """Load a `.npz` of whole tables (under tensor parallelism each rank
        keeps its level shards)."""
        if self.state is None:
            self.init_state()
        state = ckpt_io.load_state(path, self.full_state())
        self.state = self._shard_levels(state) if self._tp else state
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

    def _eval_demand(self, bitfield, rays_o, rays_d, aabb,
                     n_valid: int, ladder_tables=None) -> torch.Tensor:
        """[2] int64 (fine sample demand, kept-group demand) of one chunk
        marched in `aabb` (`_march_aabb`, built once per view), pad rays at
        index >= n_valid masked out. The two-level march (uncapped groups):
        where the eval options take the ladder kernel K4 (`tl_kernel_ok`),
        two sums of its outputs; where groups are tested at their own
        stride with coarse tightening, the closed form at group granularity
        (occupied group reps x members inside the tightened interval, an
        upper bound of the fine repack's kept members); else the candidate
        ladder's valid count and group_plan's kept groups. The single-level
        march: the candidates its per-ray stride cap keeps (the packing's
        formula), and no group demand."""
        eo = self.eval_opts
        ek = self.cfg.eval_budget_per_ray
        rok = (torch.arange(rays_o.shape[0], device=rays_o.device)
               < n_valid)[:, None]
        if self._eval_tl_uncapped and eo.tl_kernel_ok(ek, None):
            plan, cnt = ladder_plan_kernel(
                rays_o, rays_d, bitfield, eo.bound, eo.max_steps,
                eo.num_candidates, eo.tl_group, eo.min_near, aabb,
                eo.coarse_steps, eo.tl_pool, tables=ladder_tables)
            return torch.stack([
                torch.where(rok[:, 0], cnt, 0.0).sum().to(torch.int64),
                (plan.keep & rok).sum()])
        plan = None
        if self._eval_tl_uncapped:
            plan = group_plan(rays_o, rays_d, bitfield, bound=eo.bound,
                              cascades=eo.cascades, max_steps=eo.max_steps,
                              k=ek, num_candidates=eo.num_candidates,
                              group=eo.tl_group, min_near=eo.min_near,
                              aabb=aabb, coarse_steps=eo.coarse_steps, kg=-1,
                              pool=eo.tl_pool)
            groups = (plan.keep & rok).sum()
        if plan is not None and eo.occ_stride == eo.tl_group \
                and eo.coarse_steps > 0:
            g = eo.tl_group
            gi = torch.arange(eo.num_candidates // g, dtype=torch.float32,
                              device=rays_o.device)
            tr_ = plan.t0[:, None] + gi[None, :] * (g * plan.dt_min)
            xyz = rays_o[:, None, :] + tr_[..., None] * rays_d[:, None, :]
            occ_f = occupancy_at(xyz, torch.full_like(tr_, plan.dt_min),
                                 bitfield, eo.cascades, eo.bound)
            n_cand = ((plan.fars - plan.t0) / plan.dt_min).clamp(min=0.0)
            members = (n_cand[:, None] - gi[None, :] * g).clamp(0.0, float(g))
            cnt = torch.where(plan.keep & occ_f & rok, torch.ceil(members),
                              0.0)
            return torch.stack([cnt.sum().to(torch.int64), groups])
        _, _, valid = march_candidates(
            rays_o, rays_d, bitfield, eo.bound, eo.cascades, eo.dt_gamma,
            eo.max_steps, eo.num_candidates, min_near=eo.min_near, aabb=aabb,
            occ_stride=eo.occ_stride, coarse_steps=eo.coarse_steps,
            span_adaptive=eo.span_adaptive)
        valid = valid & rok
        if plan is not None:
            return torch.stack([valid.sum(), groups])
        keep, _ = ray_stride_keep(valid, ek)
        return torch.stack([keep.sum(), torch.zeros_like(keep.sum())])

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
    def render_image(self, pose, h: int, w: int, bg_color: float = 1.0,
                     use_ema: bool = True):
        """Full-image render of the EMA params (or, use_ema=False, of the
        params) -> (image [h, w, 3], depth [h, w]) tensors, with a stats
        dict appended to `self.render_stats`. With use_dense every chunk goes
        through the dense oracle, unjittered (no demand probe, no skipped
        chunk)."""
        pmesh.set_mesh(self.mesh)
        t_start = time.perf_counter()
        chunk = self.cfg.eval_chunk
        st = self.state
        params = st.ema_params if use_ema else st.params
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
        # the ladder kernel's views of the bitfield, once for all chunks
        tables = None
        if (not self.use_dense and self.eval_opts.tl_kernel_ok(
                self.cfg.eval_budget_per_ray, None)):
            tables = pack_tables(st.occ.bitfield, self.eval_opts.tl_pool)

        buckets = [self.cfg.eval_flat_frac] * n_chunks
        skip = [False] * n_chunks
        if self._adaptive:
            # all chunks' demands, then ONE device -> host copy
            cnts = torch.stack([
                self._eval_demand(st.occ.bitfield, ro_c[ci], rd_c[ci], aabb,
                                  int(nv[ci]), tables)
                for ci in range(n_chunks)]).cpu().numpy()
            for ci in range(n_chunks):
                fine, grp = int(cnts[ci, 0]), int(cnts[ci, 1])
                # a chunk with no sample renders to exactly bg, unless a
                # background net paints it
                if fine == 0 and self.opts.bg_radius <= 0:
                    skip[ci] = True
                else:
                    buckets[ci] = self._pick_bucket(chunk, fine, grp)

        bg = torch.full((chunk, 3), bg_color, dtype=torch.float32, device=dev)
        zero = torch.zeros((chunk,), dtype=torch.float32, device=dev)
        imgs, deps, samples = [], [], []
        for ci in range(n_chunks):
            if skip[ci]:
                imgs.append(bg)
                deps.append(zero)
                continue
            opts = dataclasses.replace(self.eval_opts, flat_frac=buckets[ci])
            if self.use_dense:
                # the oracle queries every slot's samples: leave out the pad
                # slots at the chunk's tail (the reference renders them too)
                k = int(nv[ci])
                out = render_rays_dense(params, self.field, self.fcfg,
                                        ro_c[ci, :k], rd_c[ci, :k], opts,
                                        bg_color=bg[:k])
                out["image"] = torch.cat([out["image"], bg[k:]])
                out["depth"] = torch.cat([out["depth"], zero[k:]])
            else:
                out = render_rays(params, self.field, self.fcfg,
                                  st.occ.bitfield, ro_c[ci], rd_c[ci], opts,
                                  bg_color=bg, aabb=aabb, ladder_tables=tables)
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

    def evaluate(self, dataset=None, max_views: Optional[int] = None,
                 bg_color: float = 1.0) -> float:
        """Mean PSNR of the EMA params' renders over a dataset's views; the
        best result so far is saved as `<workspace>/checkpoints/
        <name>_best.npz` (without the optimizer state)."""
        ds = dataset or self.dataset
        meter, pmeter = PSNRMeter(), PerceptualMeter()
        n = len(ds) if max_views is None else min(max_views, len(ds))
        for vi in range(n):
            img, _ = self.render_image(ds.poses[vi], ds.h, ds.w,
                                       bg_color=bg_color)
            img = img.cpu().numpy()
            gt = np.asarray(ds.images[vi], np.float32) / 255.0
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + bg_color * (1 - gt[..., 3:])
            meter.update(img, gt)
            pmeter.update(img, gt)
        result = meter.measure()
        self.eval_history.append({"step": int(self.state.step), "psnr": result,
                                  pmeter.kind: pmeter.measure()})
        if self.cfg.workspace and result > getattr(self, "_best_psnr", -1.0):
            self._best_psnr = result
            state = self.full_state()
            if self.rank0:
                ckpt_io.save_state(os.path.join(
                    self.cfg.workspace, "checkpoints",
                    f"{self.name}_best.npz"), state, full=False)
        return result
