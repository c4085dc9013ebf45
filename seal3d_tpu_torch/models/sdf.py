"""SDF fitting network (port of seal3d_tpu/models/sdf.py): the hash grid
(16 levels, F=2, T=2^19, on the plain `xla` gather) of x mapped to [0, 1],
then a bias-free 3x64 MLP to one signed distance; `clip_sdf` clamps it as
jnp.clip does, min(max(.)) (the gradient at a tie split in half)."""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch

from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, hashgrid_encode,
                                           hashgrid_init)
from seal3d_tpu_torch.ops.mlp import mlp_apply, mlp_init
from seal3d_tpu_torch.ops.tensorf_vm import _clip


@dataclass(frozen=True)
class SDFConfig:
    """The reference's SDFConfig: same fields and defaults."""

    bound: float = 1.0
    num_layers: int = 3
    hidden_dim: int = 64
    log2_hashmap_size: int = 19
    clip_sdf: Optional[float] = None
    grid_backend: str = "xla"

    @cached_property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=self.log2_hashmap_size,
                              desired_resolution=2048,
                              backend=self.grid_backend)


def init(cfg: SDFConfig, generator: Optional[torch.Generator] = None,
         device=None):
    dims = ([cfg.grid.output_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [1])
    kw = dict(generator=generator, device=device)
    return {"encoder": hashgrid_init(cfg.grid, **kw),
            "net": mlp_init(dims, **kw)}


def apply(params, cfg: SDFConfig, x: torch.Tensor) -> torch.Tensor:
    """x [M, 3] in [-bound, bound] -> sdf [M]."""
    xn = (x + cfg.bound) / (2.0 * cfg.bound)
    out = mlp_apply(params["net"],
                    hashgrid_encode(params["encoder"], xn, cfg.grid))[..., 0]
    if cfg.clip_sdf is not None:
        out = _clip(out, -cfg.clip_sdf, cfg.clip_sdf)
    return out
