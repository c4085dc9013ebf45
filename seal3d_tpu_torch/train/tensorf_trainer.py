"""TensoRF trainer (port of seal3d_tpu/train/tensorf_trainer.py): the
family's grouped optimizer (factors at lr_factor, basis and colour nets at
lr_net, `aabb` frozen), the L1 density sparsity term, relaxed to
`l1_weight_rest` after the first upsample, a log-spaced voxel upsample
schedule and a one-shot `aabb` shrink. Factor shapes change at each such
milestone, so `train` runs the base loop in segments between them and
re-creates the optimizer state (and the EMA, from the new params) at each.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from seal3d_tpu_torch.models import tensorf
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.optim import tensorf_optimizer
from seal3d_tpu_torch.train.trainer import TrainConfig, Trainer


class TensoRFTrainer(Trainer):
    def __init__(self, field_cfg: tensorf.TensoRFConfig, opts,
                 cfg: TrainConfig, dataset=None, seed: int = 0, device=None,
                 name: str = "tensorf", l1_weight: float = 1e-4,
                 l1_weight_rest: float = 0.0, lr_factor: float = 2e-2,
                 lr_net: float = 1e-3,
                 upsample_steps: Sequence[int] = (2000, 3000, 4000, 5500,
                                                  7000),
                 n_voxel_init: int = 128**3, n_voxel_final: int = 300**3,
                 shrink_step: Optional[int] = 1000, use_dense: bool = False,
                 mesh=None):
        self.l1_weight = l1_weight
        self.l1_weight_rest = l1_weight_rest
        self.upsample_schedule = self._voxel_schedule(
            upsample_steps, n_voxel_init, n_voxel_final)
        self.shrink_step = shrink_step
        # one {"step", "resolution", **train_stats} per train segment
        self.segment_stats = []
        super().__init__(tensorf, field_cfg, opts, cfg, dataset=dataset,
                         seed=seed, device=device, name=name,
                         use_dense=use_dense, reg_fn=self._reg, mesh=mesh,
                         optimizer=tensorf_optimizer(cfg.max_steps, lr_factor,
                                                     lr_net))

    def _reg(self, params):
        return self.l1_weight * tensorf.density_loss(params, self.fcfg)

    @staticmethod
    def _voxel_schedule(steps, n_init, n_final) -> dict:
        """{step: voxel count}, log-spaced from n_init (excluded) to
        n_final over the upsample steps."""
        if not steps:
            return {}
        ns = np.round(np.exp(np.linspace(np.log(n_init), np.log(n_final),
                                         len(steps) + 1))).astype(np.int64)[1:]
        return dict(zip(steps, ns))

    def _reset_state(self, params):
        """New params with a fresh optimizer state and the EMA a copy."""
        self.state = self.state._replace(
            params=params, opt_state=self.optimizer.init(params),
            ema_params=ckpt_io.map_tree(params, lambda _, t: t.clone()))

    def maybe_resize(self, step: int):
        """The milestones of `step`: the shrink to the occupied box, then an
        upsample (after which the L1 weight relaxes); either re-creates the
        optimizer state and resets the EMA."""
        params, changed = self.state.params, False
        if self.shrink_step is not None and step == self.shrink_step:
            occ = self.state.occ
            params = tensorf.shrink_model(
                params, self.fcfg, occ.density_grid, float(occ.mean_density),
                self.cfg.density_thresh)
            changed = True
        if step in self.upsample_schedule:
            reso = tensorf.n_to_reso(int(self.upsample_schedule[step]),
                                     params["aabb"])
            params = tensorf.upsample_model(params, self.fcfg, reso)
            self.l1_weight = self.l1_weight_rest
            changed = True
        if changed:
            self._reset_state(params)

    def train(self, steps: Optional[int] = None, log_every: int = 500) -> dict:
        """The base loop in segments cut at the milestones below `steps`
        (compared with `steps` itself, as the reference does), resizing
        between segments; each segment's timings go to `segment_stats`.
        Returns the last logged {"loss": float}."""
        if self.state is None:
            self.init_state()
        steps = steps if steps is not None else self.cfg.max_steps
        milestones = sorted(set(
            [s for s in self.upsample_schedule if s < steps]
            + ([self.shrink_step] if self.shrink_step
               and self.shrink_step < steps else [])))
        start = int(self.state.step)
        bounds = [m - start for m in milestones if m > start] + [steps]
        done, last = 0, {}
        for b in bounds:
            if b - done > 0:
                step0 = start + done
                last = super().train(steps=b - done, log_every=log_every)
                self.segment_stats.append({
                    "step": step0,
                    "resolution": ckpt_io.tensorf_resolution(self.state.params),
                    **self.train_stats})
                done = b
            if done < steps:
                self.maybe_resize(int(self.state.step))
        return last

    def load_checkpoint(self, path: str):
        """A `.pth` (the reference's format) is re-instantiated at its own
        resolution, into params with a fresh optimizer state and EMA; an
        `.npz` loads at the file's leaf shapes (after an upsample or a
        shrink they differ from the init's)."""
        if self.state is None:
            self.init_state()
        if path.endswith(".pth"):
            params, res = ckpt_io.import_torch_tensorf(path, self.fcfg,
                                                       device=self.device)
            self._reset_state(params)
            print(f"[ckpt] torch tensorf checkpoint at resolution {res}")
            return self.state
        self.state = ckpt_io.load_state(path, self.state, take_shapes=True)
        return self.state

