"""Multiresolution hash/tiled/wrap grid encoding (port of
seal3d_tpu/ops/hashgrid.py).

`HashGridConfig.level_params` is copied exactly: its per-backend padding
fixes the table layout (the 'halo' backend pads every level to T, so level l
starts at l*T), and checkpoint interchange with the JAX package depends on
it. Backends:
- 'halo' (the -O path, gridtype 'wrap'): the hand-written K1 kernel on a CUDA
  tensor, its plain version on a CPU tensor (ops/halo_encode.py);
- 'xla': the plain corner gather, any gridtype.
The reference's 'pallas' and 'bucket' backends are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import torch

_PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF


def _corner_offsets(dim: int, device=None) -> torch.Tensor:
    """Static [2^dim, dim] corner offsets of a grid cell (bit d of corner i
    is its offset along axis d)."""
    return torch.tensor([[(i >> d) & 1 for d in range(dim)]
                         for i in range(2**dim)], dtype=torch.int64,
                        device=device)


@dataclass(frozen=True)
class HashGridConfig:
    """Static hash-grid hyperparameters; same fields and defaults as the
    reference's HashGridConfig (see its docstrings for gridtype/backend)."""

    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 2048
    gridtype: str = "hash"  # 'hash' | 'tiled' | 'wrap'
    align_corners: bool = False
    interpolation: str = "linear"  # 'linear' | 'smoothstep'
    input_dim: int = 3
    backend: str = "xla"
    shard_levels: bool = False

    @cached_property
    def per_level_scale(self) -> float:
        if self.num_levels <= 1:
            return 1.0
        return math.exp(
            math.log(self.desired_resolution / self.base_resolution)
            / (self.num_levels - 1))

    @cached_property
    def level_params(self) -> Tuple[Tuple[int, int, int, bool, float], ...]:
        """Per level: (resolution, offset, params_in_level, use_hash, scale);
        `scale` is the fractional interpolation scale base*g^l - 1."""
        out = []
        offset = 0
        hashmap_size = 2**self.log2_hashmap_size
        for lvl in range(self.num_levels):
            scale = self.base_resolution * (self.per_level_scale**lvl) - 1.0
            resolution = int(math.ceil(scale)) + (1 if self.align_corners else 2)
            dense_size = resolution**self.input_dim
            if self.backend in ("pallas", "halo") or self.shard_levels:
                params_in_level = hashmap_size
            else:
                params_in_level = min(((dense_size + 7) // 8) * 8, hashmap_size)
            use_hash = self.gridtype == "hash" and dense_size > hashmap_size
            out.append((resolution, offset, params_in_level, use_hash, scale))
            offset += params_in_level
        return tuple(out)

    @cached_property
    def total_params(self) -> int:
        _, off, n, _, _ = self.level_params[-1]
        return off + n

    @cached_property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def hashgrid_init(cfg: HashGridConfig, generator: Optional[torch.Generator] = None,
                  device=None, std: float = 1e-4) -> torch.Tensor:
    """Uniform(-std, std) [total_params, level_dim] table."""
    u = torch.rand((cfg.total_params, cfg.level_dim), generator=generator,
                   dtype=torch.float32, device=device)
    return u * (2.0 * std) - std


def wrap_period(params_in_level: int) -> int:
    """The per-dim wrap period P for a 'wrap' level, or 0 when the level size
    is not a usable cube (P^3 == T, P a power of two >= 4)."""
    period = round(params_in_level ** (1 / 3))
    if period**3 == params_in_level and period >= 4 and (
            period & (period - 1)) == 0:
        return period
    return 0


def _corner_indices(pos0: torch.Tensor, resolution: int, use_hash: bool,
                    params_in_level: int, dim: int,
                    gridtype: str = "hash") -> torch.Tensor:
    """[M, 2^dim, dim] int64 corner coords -> [M, 2^dim] table-local indices.
    uint32 wraparound of the reference is emulated by masking in int64."""
    if gridtype == "wrap" and dim == 3:
        period = wrap_period(params_in_level)
        if period and (resolution**dim > params_in_level
                       or resolution <= period):
            wc = pos0 & (period - 1)
            return (wc[..., 0] * period + wc[..., 1]) * period + wc[..., 2]
    if use_hash:
        h = (pos0[..., 0] * _PRIMES[0]) & _U32
        for d in range(1, dim):
            h = h ^ ((pos0[..., d] * _PRIMES[d]) & _U32)
        return h & (params_in_level - 1)
    if resolution**dim <= params_in_level:
        idx = sum(pos0[..., d] * resolution**d for d in range(dim))
        return idx.clamp(max=params_in_level - 1)
    idx = sum(pos0[..., d] * ((resolution**d) & _U32) for d in range(dim))
    return (idx & _U32) % params_in_level


def corner_indices_weights(xf: torch.Tensor, cfg: HashGridConfig):
    """All levels' corner indices and interpolation weights.

    xf: [M, dim] positions in [0, 1] ->
      idx [M, L, 2^dim] int64 global table indices,
      w   [M, L, 2^dim] f32 interpolation weights.
    """
    dim = cfg.input_dim
    corners = _corner_offsets(dim, xf.device)
    all_idx, all_w = [], []
    for resolution, offset, params_in_level, use_hash, scale in cfg.level_params:
        pos = xf * scale + (0.0 if cfg.align_corners else 0.5)
        pos = pos.clamp(0.0, float(resolution - 1))
        pos0 = torch.floor(pos)
        frac = pos - pos0
        if cfg.interpolation == "smoothstep":
            frac = frac * frac * (3.0 - 2.0 * frac)
        cpos = pos0.to(torch.int64)[:, None, :] + corners[None, :, :]
        cpos = cpos.clamp(0, resolution - 1)
        idx = _corner_indices(cpos, resolution, use_hash, params_in_level,
                              dim, cfg.gridtype) + offset
        w = torch.where(corners[None, :, :] == 1, frac[:, None, :],
                        1.0 - frac[:, None, :]).prod(-1)
        all_idx.append(idx)
        all_w.append(w)
    return torch.stack(all_idx, dim=1), torch.stack(all_w, dim=1)


def gather_encode(table: torch.Tensor, xf: torch.Tensor,
                  cfg: HashGridConfig) -> torch.Tensor:
    """Plain corner gather + weighted sum: [M, dim] -> [M, L, F]."""
    m = xf.shape[0]
    idx, w = corner_indices_weights(xf, cfg)
    feats = table[idx.reshape(m, -1)].reshape(
        m, cfg.num_levels, 2**cfg.input_dim, table.shape[-1])
    return (feats * w[..., None]).sum(dim=2)


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode positions: table [total_params, F], x [..., dim] in [0, 1] ->
    [..., L*F] level-major features. F is table.shape[-1] (stacked tables
    widen it). `valid` zeroes invalid rows on the halo backend (the xla
    backend ignores it, as in the reference)."""
    dim = cfg.input_dim
    f_dim = table.shape[-1]
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, dim).to(torch.float32)
    if cfg.shard_levels:
        raise NotImplementedError(
            "level-sharded tensor parallelism is TPU-mesh machinery the port "
            "leaves out (ROADMAP.md 'Not to port')")
    if cfg.backend == "halo":
        if cfg.gridtype != "wrap" or dim != 3 or cfg.align_corners:
            raise ValueError("halo backend requires gridtype='wrap', "
                             "input_dim=3 and align_corners=False")
        from seal3d_tpu_torch.ops.halo_encode import halo_encode

        vf = None if valid is None else valid.reshape(-1)
        out = halo_encode(table, xf, vf, cfg)
    elif cfg.backend == "xla":
        out = gather_encode(table, xf, cfg)
    else:
        raise NotImplementedError(
            f"grid backend {cfg.backend!r} (kernels K2/K3/K5) is not ported "
            "yet: ROADMAP.md Queue 1, 'Other backends and families'")
    return out.reshape(*batch_shape, cfg.num_levels * f_dim)


def hashgrid_encode_stacked(tables: Sequence[torch.Tensor], x: torch.Tensor,
                            cfg: HashGridConfig,
                            valid: Optional[torch.Tensor] = None):
    """Encode through several same-config tables with one widened gather
    (NGP's sigma + color grids share every corner index and weight).
    Returns one [..., L*F_i] tensor per table."""
    widths = [t.shape[-1] for t in tables]
    out = hashgrid_encode(torch.cat(list(tables), dim=-1), x, cfg, valid=valid)
    out = out.reshape(*out.shape[:-1], cfg.num_levels, sum(widths))
    parts, start = [], 0
    for f in widths:
        part = out[..., start:start + f]
        parts.append(part.reshape(*part.shape[:-2], cfg.num_levels * f))
        start += f
    return parts
