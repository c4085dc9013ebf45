"""SDF fitting trainer (port of seal3d_tpu/train/sdf_trainer.py): Adam at a
constant rate (optax.adam: b1 0.9, b2 0.999, eps 1e-8) on the MAPE of the
predicted signed distance over online point batches; no eikonal term, as in
the reference. `evaluate` is the mean absolute error on a fresh batch,
`save_mesh` the zero level set through the port's `extract_geometry`."""

from __future__ import annotations

import time
from typing import Optional

import torch

from seal3d_tpu_torch.models import sdf as sdf_model
from seal3d_tpu_torch.runtime.mesh_export import extract_geometry, save_mesh
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates
from seal3d_tpu_torch.train.trainer import TIMING_WARMUP, Trainer, _Clock
from seal3d_tpu_torch.utils.losses import mape_loss


class SDFTrainer:
    def __init__(self, cfg: sdf_model.SDFConfig, dataset, lr: float = 1e-3,
                 num_points: int = 16384, seed: int = 0, workspace=None):
        self.cfg = cfg
        self.dataset = dataset
        self.num_points = num_points
        self.workspace = workspace
        self.device = dataset.device
        params = sdf_model.init(cfg,
                                generator=torch.Generator().manual_seed(seed))
        self.params = ckpt_io.map_tree(params,
                                       lambda _, t: t.to(self.device))
        self.optimizer = Optimizer(lr, None, b2=0.999, eps=1e-8)
        self.opt_state = self.optimizer.init(self.params)
        # the last train() call: {"steps", "window_steps", "window_s"}
        self.train_stats = {}

    def step(self, pts: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """One Adam step on the MAPE of (pts, gt) -> the loss (on device)."""
        def loss_fn(p):
            pred = sdf_model.apply(p, self.cfg, pts)
            return mape_loss(pred[:, None], gt[:, None]), None

        loss, grads, _ = Trainer._value_and_grads(self.params, loss_fn)
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state)
        self.params = apply_updates(self.params, updates)
        return loss

    def train(self, steps: int = 1000, log_every: int = 200,
              silent: bool = False) -> float:
        """`steps` steps on fresh batches; the host reads the loss only at
        logged steps. Fills `train_stats` (the steps after the first
        TIMING_WARMUP timed on the device's clock)."""
        clock = _Clock(self.device)
        t0 = time.time()
        w0, loss = None, None
        for i in range(steps):
            if i == TIMING_WARMUP:
                w0 = clock.mark()
            pts, gt = self.dataset.batch(self.num_points)
            loss = self.step(pts, gt)
            if not silent and (i % log_every == 0 or i == steps - 1):
                print(f"[sdf] step {i} loss={float(loss):.5f} "
                      f"({(i + 1) / (time.time() - t0):.1f} it/s)")
        end = clock.mark()
        self.train_stats = {
            "steps": steps,
            "window_steps": steps - TIMING_WARMUP if w0 is not None else 0,
            "window_s": clock.seconds(w0, end) if w0 is not None else 0.0}
        return float(loss)

    @torch.no_grad()
    def evaluate(self, n: int = 8192) -> float:
        pts, gt = self.dataset.batch(n)
        pred = sdf_model.apply(self.params, self.cfg, pts)
        return float((pred - gt).abs().mean())

    def save_mesh(self, path: str, resolution: int = 256):
        """The zero level set of the field on a resolution^3 lattice over
        [-1, 1]^3 -> an ascii .ply (or .obj) at `path`; returns (verts,
        tris)."""
        verts, tris = extract_geometry(
            lambda x: -sdf_model.apply(self.params, self.cfg, x),
            bound=1.0, resolution=resolution, threshold=0.0,
            device=self.device)
        save_mesh(path, verts, tris)
        return verts, tris
