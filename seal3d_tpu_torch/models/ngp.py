"""Instant-NGP-style field (port of seal3d_tpu/models/ngp.py), as functions
over a params dict with the reference's keys and shapes:

    {"encoder": [T_total, 2], "encoder_color": [T_total, 2],
     "sigma_net": [{"w": [in, out]}, ...], "color_net": [...]}

and, with bg_radius > 0, the background net: "encoder_bg" (a 2-D hash grid
over sphere coordinates, L=4, F=2, T=2^19, on the plain `xla` gather) and
"bg_net" (its features and SH of the view direction -> 2x64 MLP -> rgb).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch

from seal3d_tpu_torch.models.mlp import mlp_apply, mlp_init
from seal3d_tpu_torch.ops.field_head import field_head
from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, hashgrid_encode,
                                           hashgrid_encode_stacked,
                                           hashgrid_init)
from seal3d_tpu_torch.ops.sh import sh_encode, sh_encode_dim
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp
from seal3d_tpu_torch.train.checkpoint import map_tree

# the params' MLPs, whose weight gradients their casts sum over a data mesh
# (models/mlp.py)
MLP_NETS = ("sigma_net", "color_net", "bg_net")


@dataclass(frozen=True)
class NGPConfig:
    bound: float = 1.0
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    sh_degree: int = 4
    log2_hashmap_size: int = 19
    bg_radius: float = -1.0
    num_levels: int = 16
    level_dim: int = 2
    grid_backend: str = "xla"
    gridtype: str = "hash"
    grid_shard_levels: bool = False

    @cached_property
    def grid(self) -> HashGridConfig:
        return HashGridConfig(
            num_levels=self.num_levels,
            level_dim=self.level_dim,
            base_resolution=16,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(2048 * self.bound),
            backend=self.grid_backend,
            gridtype=self.gridtype,
            shard_levels=self.grid_shard_levels,
        )

    @cached_property
    def grid_bg(self) -> HashGridConfig:
        return HashGridConfig(num_levels=4, level_dim=2, base_resolution=16,
                              log2_hashmap_size=19, desired_resolution=2048,
                              input_dim=2)


def init(cfg: NGPConfig, generator: Optional[torch.Generator] = None,
         device=None):
    """Random params with the reference's shapes and init distributions."""
    grid_dim = cfg.grid.output_dim
    sh_dim = sh_encode_dim(cfg.sh_degree)
    sigma_dims = ([grid_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
                  + [1 + cfg.geo_feat_dim])
    color_in = sh_dim + cfg.geo_feat_dim + grid_dim
    color_dims = ([color_in] + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1)
                  + [3])
    kw = dict(generator=generator, device=device)
    params = {
        "encoder": hashgrid_init(cfg.grid, **kw),
        "encoder_color": hashgrid_init(cfg.grid, **kw),
        "sigma_net": mlp_init(sigma_dims, **kw),
        "color_net": mlp_init(color_dims, **kw),
    }
    if cfg.bg_radius > 0:
        bg_dims = ([cfg.grid_bg.output_dim + sh_dim]
                   + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3])
        params["encoder_bg"] = hashgrid_init(cfg.grid_bg, **kw)
        params["bg_net"] = mlp_init(bg_dims, **kw)
    return params


def _normalize(x: torch.Tensor, bound: float) -> torch.Tensor:
    """[-bound, bound] -> [0, 1] for the grid encoders."""
    return (x + bound) / (2.0 * bound)


def density(params, cfg: NGPConfig, x: torch.Tensor):
    """x [M, 3] in [-bound, bound] -> {"sigma": [M], "geo_feat": [M, G]}."""
    feat = hashgrid_encode(params["encoder"], _normalize(x, cfg.bound), cfg.grid)
    h = mlp_apply(params["sigma_net"], feat)
    return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}


def color(params, cfg: NGPConfig, x: torch.Tensor, d: torch.Tensor,
          geo_feat: torch.Tensor) -> torch.Tensor:
    """x [M, 3], d [M, 3] unit dirs -> rgb [M, 3] in [0, 1]."""
    d_enc = sh_encode(d, cfg.sh_degree)
    c_enc = hashgrid_encode(params["encoder_color"], _normalize(x, cfg.bound),
                            cfg.grid)
    h = mlp_apply(params["color_net"], torch.cat([d_enc, geo_feat, c_enc], -1))
    return torch.sigmoid(h)


def apply(params, cfg: NGPConfig, x: torch.Tensor, d: torch.Tensor,
          valid: Optional[torch.Tensor] = None):
    """(sigma [M], rgb [M, 3]). The sigma and color grids share every corner,
    so one stacked F=4 encode serves both; `valid` zeroes the features of
    packed-tail rows on the halo backend. The MLPs, SH and activations
    after it are the field head (ops/field_head.py: a kernel pair where
    the MLPs are frozen, the plain composition where they train)."""
    enc = hashgrid_encode_stacked(
        (params["encoder"], params["encoder_color"]),
        _normalize(x, cfg.bound), cfg.grid, valid=valid)
    return field_head(enc, d, params["sigma_net"], params["color_net"],
                      cfg.sh_degree)


def param_lr_scales(params, encoder_scale: float = 1.0,
                    net_scale: float = 1.0):
    """Per-leaf learning-rate multipliers shaped like params: encoder_scale
    for every top-level key whose name holds "encoder", net_scale for the
    rest (the reference's get_params groups; both 1 by default)."""
    return {k: map_tree(v, lambda _, t, s=(encoder_scale if "encoder" in k
                                           else net_scale): s)
            for k, v in params.items()}


def background(params, cfg: NGPConfig, sph: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    """sph [M, 2] sphere coordinates in [-1, 1], d [M, 3] unit dirs -> rgb
    [M, 3] of the background net."""
    h_enc = hashgrid_encode(params["encoder_bg"], (sph + 1.0) * 0.5,
                            cfg.grid_bg)
    d_enc = sh_encode(d, cfg.sh_degree)
    h = mlp_apply(params["bg_net"], torch.cat([h_enc, d_enc], dim=-1))
    return torch.sigmoid(h)
