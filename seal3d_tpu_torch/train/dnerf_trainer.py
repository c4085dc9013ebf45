"""D-NeRF trainer (port of seal3d_tpu/train/dnerf_trainer.py): one image and
one time a step, the march against that time's slice of the time-sliced
occupancy grid, and its refresh by `slices_per_update` slices every
`update_interval` steps with a cursor that wraps around the time axis.

The loss is the photometric MSE plus, where set, `deform_reg` times the L1
of the deformation at the marched surface points (rays_o + depth * rays_d,
depth without gradient) and `sigma_reg` times the mean density at 4096
uniform points of the box at the step's time. The L1 is written
`where(x >= 0, x, -x)`: its gradient at 0 is +1, as jax.grad(jnp.abs)
gives, where torch.abs's is 0; the deform net's last layer starts at zero,
so dx is exactly 0 at the first steps, and under the `halo` encode (which
gives positions no gradient) this term is all that moves the deform net.
Evaluation inherits the render options (budget and flat_frac of the eval
point) and pads the last chunk of a view with rays from the origin along
(1, 1, 1), as the reference does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from seal3d_tpu_torch.data.rays import get_full_rays, get_rays
from seal3d_tpu_torch.models import dnerf
from seal3d_tpu_torch.parallel import mesh as pmesh
from seal3d_tpu_torch.render.occupancy import (occupancy_t_init,
                                               occupancy_t_update)
from seal3d_tpu_torch.render.renderer import render_rays, render_rays_dense
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.metrics import PSNRMeter
from seal3d_tpu_torch.train.trainer import (TIMING_WARMUP, StepRandom,
                                            TrainConfig, Trainer, TrainState,
                                            _Clock)

SIGMA_REG_POINTS = 4096


def l1(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at 0 (torch.abs gives 0 there)."""
    return torch.where(x >= 0, x, -x)


class DNeRFTrainer(Trainer):
    def __init__(self, field_cfg: dnerf.DNeRFConfig, opts, cfg: TrainConfig,
                 dataset=None, seed: int = 0, device=None, name: str = "dnerf",
                 time_size: int = 64, deform_reg: float = 0.0,
                 sigma_reg: float = 0.0, slices_per_update: int = 8,
                 use_dense: bool = False, mesh=None):
        self.time_size = time_size
        self.deform_reg = deform_reg
        self.sigma_reg = sigma_reg
        self.slices_per_update = slices_per_update
        self._grid_cursor = 0
        super().__init__(dnerf, field_cfg, opts, cfg, dataset=dataset,
                         seed=seed, device=device, name=name,
                         use_dense=use_dense, mesh=mesh)
        self.eval_opts_t = dataclasses.replace(
            opts, budget_per_ray=cfg.eval_budget_per_ray,
            flat_frac=cfg.eval_flat_frac)

    def attach_dataset(self, dataset):
        super().attach_dataset(dataset)
        times = (dataset.times if dataset.times is not None
                 else np.linspace(0.0, 1.0, len(dataset)))
        self._times = torch.as_tensor(np.asarray(times, np.float32),
                                      device=self.device)

    def init_state(self) -> TrainState:
        params = dnerf.init(self.fcfg, generator=self.init_generator)
        params = ckpt_io.map_tree(params, lambda _, t: t.to(self.device))
        self.state = TrainState(
            params=params, opt_state=self.optimizer.init(params),
            ema_params=ckpt_io.map_tree(params, lambda _, t: t.clone()),
            occ=occupancy_t_init(self.time_size, self.opts.cascades,
                                 device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        return self.state

    # ------------------------------------------------------------ train step

    def draw_step_random(self) -> StepRandom:
        """The base trainer's draws, plus the sigma_reg points."""
        rand = super().draw_step_random()
        if self.sigma_reg > 0:
            b = self.opts.bound
            pts = torch.rand((SIGMA_REG_POINTS, 3), generator=self.generator,
                             device=self.device) * (2 * b) - b
            rand = rand._replace(reg_points=pts)
        return rand

    def sample_batch(self, rand: StepRandom) -> dict:
        """Rays, ground truth, background and time of one step's pixels
        (the reference's D-NeRF batch: no colour-space conversion)."""
        h, w, n = self.dataset.h, self.dataset.w, rand.inds.shape[0]
        rays = get_rays(self._poses[rand.img_idx], self._intrinsics, h, w, n,
                        inds=rand.inds)
        img = self._images[rand.img_idx].reshape(h * w, -1)
        gt = img[rand.inds].to(torch.float32) / 255.0
        bg = rand.bg
        if bg is None:
            bg = torch.ones((n, 3), dtype=torch.float32, device=gt.device)
        if gt.shape[-1] == 4:
            gt = gt[:, :3] * gt[:, 3:] + bg * (1.0 - gt[:, 3:])
        batch = {"rays_o": rays["rays_o"], "rays_d": rays["rays_d"],
                 "gt": gt, "bg": bg}
        for k in ("z_jitter", "pdf_u"):
            if getattr(rand, k) is not None:
                batch[k] = getattr(rand, k)
        # the rays' tensors are this rank's slice; time and the sigma_reg
        # points are the step's, on every rank
        batch = pmesh.shard_rays(batch, self.mesh)
        batch["time"] = self._times[rand.img_idx]
        if rand.reg_points is not None:
            batch["reg_points"] = rand.reg_points
        return batch

    def time_slice(self, t: torch.Tensor) -> torch.Tensor:
        """[] int64 index of the time slice of t in [0, 1]."""
        return (t * self.time_size).to(torch.int32).clamp(
            0, self.time_size - 1).to(torch.int64)

    def loss_fn(self, params, bitfield_t: torch.Tensor, batch: dict,
                jitter: Optional[torch.Tensor]):
        """(loss [], render dict) of one batch at its time."""
        fcfg, t = self.fcfg, batch["time"]
        timed = dnerf.with_time(t)
        if self.use_dense:
            out = render_rays_dense(
                params, timed, fcfg, batch["rays_o"], batch["rays_d"],
                self.opts, bg_color=batch["bg"], perturb=True,
                z_jitter=batch.get("z_jitter"), pdf_u=batch.get("pdf_u"),
                generator=self.generator)
        else:
            out = render_rays(params, timed, fcfg, bitfield_t,
                              batch["rays_o"], batch["rays_d"],
                              self.step_opts, bg_color=batch["bg"],
                              jitter=jitter)
        loss = ((out["image"] - batch["gt"]) ** 2).mean(-1).mean()
        if self.deform_reg > 0 and fcfg.variant == "deform":
            xs = (batch["rays_o"]
                  + out["depth"].detach()[:, None] * batch["rays_d"])
            dx = dnerf.deformation(params, fcfg, xs, t)
            loss = loss + self.deform_reg * l1(dx).mean()
        if self.sigma_reg > 0:
            sr = dnerf.density(params, fcfg, batch["reg_points"], t)["sigma"]
            loss = loss + self.sigma_reg * sr.mean()
        return loss, out

    def train_step(self, rand: Optional[StepRandom] = None) -> dict:
        """One step: batch of one view at its time, the loss against that
        time's bitfield, its gradient, Adam (with the MLP scale) and EMA.
        Returns device tensors {"loss", "num_samples"} (no host sync)."""
        st = self.state
        pmesh.set_mesh(self.mesh)
        if self.mesh is not None:
            self.mesh.reset_log()
        rand = rand if rand is not None else self.draw_step_random()
        batch = self.sample_batch(rand)
        bitfield_t = st.occ.bitfield[self.time_slice(batch["time"])]
        jitter = pmesh.shard_rays(rand.jitter, self.mesh)
        loss, grads, out = self._value_and_grads(
            st.params, lambda p: self.loss_fn(p, bitfield_t, batch, jitter))
        loss, grads, n_samples = self.reduce_step(loss, grads,
                                                  out["num_samples"])
        self.state = self._apply_grads(st, grads)
        return {"loss": loss, "num_samples": n_samples}

    # ------------------------------------------------------------ grid, loop

    @torch.no_grad()
    def update_grid(self, start_slice: Optional[int] = None, **rand):
        """Refresh `slices_per_update` time slices from `start_slice`
        (default: the cursor, which then moves on by as many, wrapping),
        through the deform field's density at the current params. `rand`
        (uni_codes, uniforms, jitter, time_jitter) as in
        `occupancy_t_update`; what is not given comes from the trainer's
        generator."""
        pmesh.set_mesh(self.mesh)
        params, fcfg = self.state.params, self.fcfg
        scale = self.opts.density_scale
        if start_slice is None:
            start_slice = self._grid_cursor
            self._grid_cursor = ((self._grid_cursor + self.slices_per_update)
                                 % self.time_size)
        t_indices = [(start_slice + i) % self.time_size
                     for i in range(self.slices_per_update)]

        def density_fn(x, t):
            return dnerf.density(params, fcfg, x, t)["sigma"] * scale

        occ = occupancy_t_update(self.state.occ, density_fn, self.opts.bound,
                                 t_indices,
                                 density_thresh=self.cfg.density_thresh,
                                 generator=self.generator, **rand)
        self.state = self.state._replace(occ=occ)
        return occ

    def train(self, steps: Optional[int] = None, log_every: int = 500,
              update_interval: int = 100) -> dict:
        """Run `steps` train steps with a time-grid update every
        `update_interval` steps (the reference's 100; none with use_dense).
        Fills `train_stats` as the base trainer does (`grid_updates` are
        (False, seconds) pairs). Returns the last logged {"loss": float}."""
        if self.state is None:
            self.init_state()
        steps = steps if steps is not None else self.cfg.max_steps
        clock = _Clock(self.device)
        step_i = int(self.state.step)
        grid_marks, w0, last = [], None, {}
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            if not self.use_dense and step_i % update_interval == 0:
                a = clock.mark()
                self.update_grid()
                grid_marks.append((False, a, clock.mark()))
            if i == TIMING_WARMUP + 1:
                w0 = clock.mark()
            metrics = self.train_step()
            step_i += 1
            if (i - 1) % log_every == 0 or i == steps:
                last = {"loss": float(metrics["loss"])}
                self.history.append({"step": step_i, **last})
                self._log(f"[dnerf] step={step_i} loss={last['loss']:.5f} "
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

    # ------------------------------------------------------------- rendering

    @torch.no_grad()
    def render_image_t(self, pose, h: int, w: int, t: float,
                       bg_color: float = 1.0, use_ema: bool = True,
                       chunk: Optional[int] = None):
        """Full-image render at time t -> (image [h, w, 3], depth [h, w]),
        in chunks of `chunk` rays (cfg.eval_chunk), the last padded with
        rays from the origin along (1, 1, 1); a stats dict is appended to
        `render_stats`."""
        t_start = time.perf_counter()
        chunk = chunk or self.cfg.eval_chunk
        st, dev = self.state, self.device
        params = st.ema_params if use_ema else st.params
        rays = get_full_rays(torch.as_tensor(pose, dtype=torch.float32,
                                             device=dev),
                             self._intrinsics, h, w)
        bitfield = st.occ.bitfield[min(int(t * self.time_size),
                                       self.time_size - 1)]
        timed = dnerf.with_time(torch.tensor(t, dtype=torch.float32,
                                             device=dev))
        n = h * w
        bg = torch.full((chunk, 3), bg_color, dtype=torch.float32, device=dev)
        imgs, deps, chunks = [], [], 0
        for i in range(0, n, chunk):
            ro = rays["rays_o"][i:i + chunk]
            rd = rays["rays_d"][i:i + chunk]
            k = ro.shape[0]
            if k < chunk:
                ro = torch.cat([ro, ro.new_zeros((chunk - k, 3))])
                rd = torch.cat([rd, rd.new_ones((chunk - k, 3))])
            if self.use_dense:
                out = render_rays_dense(params, timed, self.fcfg, ro, rd,
                                        self.eval_opts_t, bg_color=bg)
            else:
                out = render_rays(params, timed, self.fcfg, bitfield, ro, rd,
                                  self.eval_opts_t, bg_color=bg)
            imgs.append(out["image"][:k])
            deps.append(out["depth"][:k])
            chunks += 1
        image = torch.cat(imgs).reshape(h, w, 3)
        depth = torch.cat(deps).reshape(h, w)
        self.render_stats.append({
            "seconds": time.perf_counter() - t_start,
            "chunks_rendered": chunks,
            "nonfinite": int((~torch.isfinite(image)).sum()
                             + (~torch.isfinite(depth)).sum())})
        return image, depth

    def evaluate(self, dataset=None, max_views: Optional[int] = None,
                 bg_color: float = 1.0) -> float:
        """Mean PSNR of the EMA params' renders over a dataset's views, each
        at its own time (evenly spaced over [0, 1] where the dataset has
        none)."""
        ds = dataset or self.dataset
        times = ds.times if ds.times is not None else np.linspace(0, 1, len(ds))
        meter = PSNRMeter()
        n = len(ds) if max_views is None else min(max_views, len(ds))
        for vi in range(n):
            img, _ = self.render_image_t(ds.poses[vi], ds.h, ds.w,
                                         float(times[vi]), bg_color=bg_color)
            gt = np.asarray(ds.images[vi], np.float32) / 255.0
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + bg_color * (1 - gt[..., 3:])
            meter.update(img.cpu().numpy(), gt)
        result = meter.measure()
        self.eval_history.append({"step": int(self.state.step),
                                  "psnr": result})
        return result
