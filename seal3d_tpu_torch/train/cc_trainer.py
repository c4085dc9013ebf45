"""CCNeRF trainer (port of seal3d_tpu/train/cc_trainer.py): dense-path
rank-residual training of one CCNeRF object. Every step renders the batch
through the K progressive reconstructions at once (opts.num_steps
stratified samples a ray, jittered by the step's `z_jitter`), composites
each, and means the per-ray MSE over K before the mean over rays, so every
rank prefix must reconstruct the image; plus l1_weight x `density_loss`.
Evaluation and rendering are the base trainer's, through the dense oracle
on the final reconstruction. The optimizer is `cc_optimizer` (factors at
2e-2, the S weights at 1e-3, transforms frozen).
"""

from __future__ import annotations

from typing import Optional

import torch

from seal3d_tpu_torch.models import ccnerf
from seal3d_tpu_torch.ops.composite import composite_dense
from seal3d_tpu_torch.ops.raymarch import near_far_from_aabb
from seal3d_tpu_torch.render.occupancy import OccupancyState
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.optim import cc_optimizer
from seal3d_tpu_torch.train.trainer import TrainConfig, Trainer


class CCNeRFTrainer(Trainer):
    def __init__(self, field_cfg: ccnerf.CCNeRFConfig, opts, cfg: TrainConfig,
                 dataset=None, seed: int = 0, device=None,
                 name: str = "ccnerf", l1_weight: float = 1e-5, mesh=None):
        self.l1_weight = l1_weight
        super().__init__(ccnerf, field_cfg, opts, cfg, dataset=dataset,
                         seed=seed, device=device, name=name, use_dense=True,
                         optimizer=cc_optimizer(cfg.max_steps), mesh=mesh)

    def loss_fn(self, params, occ: OccupancyState, batch: dict,
                jitter: Optional[torch.Tensor]):
        """(loss [], render dict of the last reconstruction with the
        detached per-ray loss meaned over K)."""
        opts, dev = self.opts, batch["rays_o"].device
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        aabb = torch.tensor(opts.aabb, dtype=torch.float32, device=dev)
        nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, opts.min_near)
        nears = nears.clamp(max=100.0)
        fars = fars.clamp(max=100.1)
        k = opts.num_steps
        lin = torch.linspace(0.0, 1.0, k, device=dev)
        z = nears[:, None] + (fars - nears)[:, None] * lin[None, :]
        sample_dist = (fars - nears) / k
        z_jitter = batch.get("z_jitter")
        if z_jitter is None:
            z_jitter = torch.rand(z.shape, generator=self.generator,
                                  device=dev)
        z = z + (z_jitter - 0.5) * sample_dist[:, None]
        xyz = rays_o[:, None] + z[..., None] * rays_d[:, None]
        xyz = xyz.clamp(-opts.bound, opts.bound).reshape(-1, 3)
        dirs = rays_d[:, None].expand(*z.shape, 3).reshape(-1, 3)
        sigma, rgb = ccnerf.apply_residual(params, self.fcfg, xyz, dirs)
        kk = sigma.shape[0]
        sigma = sigma.reshape(kk, *z.shape) * opts.density_scale
        rgb = rgb.reshape(kk, *z.shape, 3)
        deltas = torch.cat([torch.diff(z, dim=-1), sample_dist[:, None]], -1)
        out = composite_dense(sigma, rgb, deltas, z)    # broadcasts over K
        image = (out["image"]
                 + (1.0 - out["weights_sum"])[..., None] * batch["bg"])
        per_ray = ((image - batch["gt"]) ** 2).mean(-1).mean(0)
        loss = per_ray.mean() + self.l1_weight * ccnerf.density_loss(
            params, self.fcfg)
        return loss, {"image": image[-1], "depth": out["depth"][-1],
                      "per_ray": per_ray.detach(),
                      "num_samples": torch.zeros((), device=dev)}

    def load_checkpoint(self, path: str):
        """A `.pth` (the reference's format) re-instantiates the field at
        the file's ranks and resolution (fcfg follows), with a fresh
        optimizer state and the EMA a copy; an `.npz` of either package
        loads at the file's leaf shapes."""
        if self.state is None:
            self.init_state()
        if path.endswith(".pth"):
            params, self.fcfg = ckpt_io.import_torch_ccnerf(
                path, self.fcfg, device=self.device)
            self.state = self.state._replace(
                params=params, opt_state=self.optimizer.init(params),
                ema_params=ckpt_io.map_tree(params, lambda _, t: t.clone()))
            print(f"[ckpt] torch ccnerf checkpoint: resolution "
                  f"{self.fcfg.resolution}, ranks {self.fcfg.rank_vec}")
            return self.state
        self.state = ckpt_io.load_state(path, self.state, take_shapes=True)
        return self.state
