"""D-NeRF field: a dynamic (time-conditioned) NeRF in three variants (port of
seal3d_tpu/models/dnerf.py), as functions over a params dict with the
reference's keys and shapes:

    {"encoder": [T_total, 2], "deform_net" | "basis_net" | "ambient_net":
     [{"w": [in, out]}, ...], "sigma_net": [...], "color_net": [...]}

- 'deform': freq(x, 10 octaves) + freq(t, time_multires) -> 5x128 MLP -> dx;
  the warped x + dx feeds the hash grid (its last layer starts at zero, so
  training starts as a static field in canonical space);
- 'basis': a 5x128 time MLP gives sigma and colour basis weights; sigma is
  the dot of the per-point sigma features with the sigma basis, colour a
  basis-weighted sum of colour chunks;
- 'hyper': a 5x128 time MLP gives `ambient_dim` more coordinates after xyz,
  into a 4-D hash grid (always on the plain `xla` gather).

Every variant has `apply(params, cfg, x, d, t)` and `density(params, cfg, x,
t)`; `with_time(t)` gives the time-less field API the shared renderer takes.
Under `-O` the grid is K1 (the `halo` backend), which gives positions no
gradient: the deform net then gets none from the field, as in the reference,
and moves only through the trainer's `deform_reg` term.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch

from seal3d_tpu_torch.ops.freq import freq_encode, freq_encode_dim
from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, hashgrid_encode,
                                           hashgrid_init)
from seal3d_tpu_torch.ops.mlp import mlp_apply, mlp_init
from seal3d_tpu_torch.ops.sh import sh_encode, sh_encode_dim
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp

# the params' MLPs, whose weight gradients their casts sum over a data mesh
# (ops/mlp.py)
MLP_NETS = ("deform_net", "basis_net", "ambient_net", "sigma_net",
            "color_net")


@dataclass(frozen=True)
class DNeRFConfig:
    """The reference's DNeRFConfig: same fields and defaults."""

    bound: float = 1.0
    variant: str = "deform"  # 'deform' | 'basis' | 'hyper'
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    log2_hashmap_size: int = 19
    gridtype: str = "tiled"
    grid_backend: str = "xla"
    num_layers_time: int = 5
    hidden_dim_time: int = 128
    deform_multires: int = 10
    time_multires: int = 6
    sigma_basis_dim: int = 32
    color_basis_dim: int = 8
    ambient_dim: int = 1

    @cached_property
    def grid(self) -> HashGridConfig:
        in_dim = 3 + (self.ambient_dim if self.variant == "hyper" else 0)
        return HashGridConfig(
            num_levels=16, level_dim=2, base_resolution=16,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(2048 * self.bound),
            gridtype=self.gridtype, input_dim=in_dim,
            backend=self.grid_backend if in_dim == 3 else "xla")

    @cached_property
    def time_enc_dim(self) -> int:
        return freq_encode_dim(1, self.time_multires)


def init(cfg: DNeRFConfig, generator: Optional[torch.Generator] = None,
         device=None):
    """Random params with the reference's shapes and init distributions; the
    deform net's last layer is zero."""
    kw = dict(generator=generator, device=device)
    sh_dim = sh_encode_dim(cfg.sh_degree)
    time_hidden = [cfg.hidden_dim_time] * (cfg.num_layers_time - 1)
    params = {"encoder": hashgrid_init(cfg.grid, **kw)}
    if cfg.variant == "deform":
        deform_in = freq_encode_dim(3, cfg.deform_multires) + cfg.time_enc_dim
        params["deform_net"] = mlp_init([deform_in] + time_hidden + [3], **kw)
        params["deform_net"][-1]["w"] = torch.zeros_like(
            params["deform_net"][-1]["w"])
        sigma_out = 1 + cfg.geo_feat_dim
    elif cfg.variant == "basis":
        params["basis_net"] = mlp_init(
            [cfg.time_enc_dim] + time_hidden
            + [cfg.sigma_basis_dim + cfg.color_basis_dim], **kw)
        sigma_out = cfg.sigma_basis_dim + cfg.geo_feat_dim
    elif cfg.variant == "hyper":
        params["ambient_net"] = mlp_init(
            [cfg.time_enc_dim] + time_hidden + [cfg.ambient_dim], **kw)
        sigma_out = 1 + cfg.geo_feat_dim
    else:
        raise ValueError(cfg.variant)
    params["sigma_net"] = mlp_init(
        [cfg.grid.output_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
        + [sigma_out], **kw)
    color_out = 3 * cfg.color_basis_dim if cfg.variant == "basis" else 3
    params["color_net"] = mlp_init(
        [sh_dim + cfg.geo_feat_dim]
        + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [color_out],
        **kw)
    return params


def _norm(x: torch.Tensor, bound: float) -> torch.Tensor:
    return (x + bound) / (2.0 * bound)


def _time_feat(cfg: DNeRFConfig, t, n: int) -> torch.Tensor:
    """Frequency encoding of t (a scalar or [n]) broadcast to [n, 1]."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return freq_encode(t.reshape(-1, 1).expand(n, 1), cfg.time_multires)


def deformation(params, cfg: DNeRFConfig, x: torch.Tensor, t) -> torch.Tensor:
    """dx [M, 3] of the deform variant at positions x [M, 3] and time t."""
    h = torch.cat([freq_encode(x, cfg.deform_multires),
                   _time_feat(cfg, t, x.shape[0]).to(x.device)], -1)
    return mlp_apply(params["deform_net"], h)


def density(params, cfg: DNeRFConfig, x: torch.Tensor, t) -> dict:
    """x [M, 3] in [-bound, bound] at time t (a scalar or [M]) ->
    {"sigma" [M], "geo_feat" [M, G]}, plus "warped_x" (deform) or
    "color_basis" (basis)."""
    n = x.shape[0]
    if cfg.variant == "deform":
        x = x + deformation(params, cfg, x, t)
        feat = hashgrid_encode(params["encoder"], _norm(x, cfg.bound), cfg.grid)
        h = mlp_apply(params["sigma_net"], feat)
        return {"sigma": trunc_exp(h[:, 0]), "geo_feat": h[:, 1:],
                "warped_x": x}
    tf = _time_feat(cfg, t, n).to(x.device)
    if cfg.variant == "basis":
        basis = mlp_apply(params["basis_net"], tf)
        sb = basis[:, :cfg.sigma_basis_dim]
        cb = basis[:, cfg.sigma_basis_dim:]
        feat = hashgrid_encode(params["encoder"], _norm(x, cfg.bound), cfg.grid)
        h = mlp_apply(params["sigma_net"], feat)
        sigma = trunc_exp((h[:, :cfg.sigma_basis_dim] * sb).sum(-1))
        return {"sigma": sigma, "geo_feat": h[:, cfg.sigma_basis_dim:],
                "color_basis": cb}
    amb = torch.tanh(mlp_apply(params["ambient_net"], tf))
    x4 = torch.cat([_norm(x, cfg.bound), (amb + 1.0) * 0.5], -1)
    feat = hashgrid_encode(params["encoder"], x4, cfg.grid)
    h = mlp_apply(params["sigma_net"], feat)
    return {"sigma": trunc_exp(h[:, 0]), "geo_feat": h[:, 1:]}


def apply(params, cfg: DNeRFConfig, x: torch.Tensor, d: torch.Tensor, t):
    """(sigma [M], rgb [M, 3], warped x [M, 3] or None)."""
    out = density(params, cfg, x, t)
    h = mlp_apply(params["color_net"],
                  torch.cat([sh_encode(d, cfg.sh_degree), out["geo_feat"]], -1))
    if cfg.variant == "basis":
        h = h.reshape(-1, 3, cfg.color_basis_dim)
        h = (h * out["color_basis"][:, None, :]).sum(-1)
    return out["sigma"], torch.sigmoid(h), out.get("warped_x")


def with_time(t):
    """The time-less field API of the shared renderer at time t: `apply`
    (which takes and ignores the renderer's `valid`, as the reference's
    adapter does), `density` and `color` (which raises for 'basis': its
    colour needs the time basis)."""

    class TimedField:
        # the bodies below call the module's apply and density
        @staticmethod
        def apply(params, cfg, x, d, valid=None):
            sigma, rgb, _ = apply(params, cfg, x, d, t)
            return sigma, rgb

        @staticmethod
        def density(params, cfg, x):
            out = density(params, cfg, x, t)
            return {"sigma": out["sigma"], "geo_feat": out["geo_feat"]}

        @staticmethod
        def color(params, cfg, x, d, geo_feat):
            if cfg.variant == "basis":
                raise NotImplementedError("basis color needs time basis")
            h = mlp_apply(params["color_net"],
                          torch.cat([sh_encode(d, cfg.sh_degree), geo_feat],
                                    -1))
            return torch.sigmoid(h)

    return TimedField
