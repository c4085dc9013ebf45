"""Multiresolution hash/tiled/wrap grid encoding (port of
seal3d_tpu/ops/hashgrid.py).

`HashGridConfig.level_params` is copied exactly: its per-backend padding
fixes the table layout (the 'halo' and 'pallas' backends pad every level to
T, so level l starts at l*T; 'xla' and 'bucket' size levels natively,
8-aligned), and checkpoint interchange with the JAX package depends on it.
`BACKENDS` pairs each backend's plain PyTorch path with the wrapper of its
hand-written kernel (which runs the plain path on a CPU tensor):
- 'halo' (the -O path, gridtype 'wrap'): K1 (ops/halo_encode.py);
- 'pallas' (gridtype 'hash', levels padded to T) and 'bucket' (native
  levels, the reference's T=2^19 capacity): K3 and K2, one kernel pair over
  both layouts (ops/hash_encode.py);
- 'xla': the plain corner gather only, any gridtype.
Where the fused encode does not apply (align_corners or input_dim != 3) the
'pallas' backend takes its unfused branch, as the reference does: corner
indices and weights in PyTorch, the rows through K5 (ops/lookup.py).
With shard_levels on 'xla' or 'halo' under an ambient mesh with a 'model'
axis (parallel/mesh.py), each rank encodes its level shard of the table and
the features are exchanged across ranks (`encode_level_shard`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cache, cached_property
from typing import Callable, Optional, Sequence, Tuple

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


def corner_indices_weights(xf: torch.Tensor, cfg: HashGridConfig,
                           levels: Optional[range] = None):
    """All levels' corner indices and interpolation weights.

    xf: [M, dim] positions in [0, 1] ->
      idx [M, L, 2^dim] int64 global table indices,
      w   [M, L, 2^dim] f32 interpolation weights.
    With `levels` (a contiguous range) only those levels are computed, and
    the indices address a table that holds these levels alone (they count
    from the first level's offset).
    """
    dim = cfg.input_dim
    corners = _corner_offsets(dim, xf.device)
    params = cfg.level_params
    if levels is not None:
        params = params[levels.start:levels.stop]
    base = params[0][1]
    all_idx, all_w = [], []
    for resolution, offset, params_in_level, use_hash, scale in params:
        pos = xf * scale + (0.0 if cfg.align_corners else 0.5)
        pos = pos.clamp(0.0, float(resolution - 1))
        pos0 = torch.floor(pos)
        frac = pos - pos0
        if cfg.interpolation == "smoothstep":
            frac = frac * frac * (3.0 - 2.0 * frac)
        cpos = pos0.to(torch.int64)[:, None, :] + corners[None, :, :]
        cpos = cpos.clamp(0, resolution - 1)
        idx = _corner_indices(cpos, resolution, use_hash, params_in_level,
                              dim, cfg.gridtype) + (offset - base)
        f = torch.where(corners[None, :, :] == 1, frac[:, None, :],
                        1.0 - frac[:, None, :])
        # the product written out: the same roundings as prod(-1), whose
        # backward syncs the host and scans when a factor is 0
        w = f[..., 0]
        for d in range(1, dim):
            w = w * f[..., d]
        all_idx.append(idx)
        all_w.append(w)
    return torch.stack(all_idx, dim=1), torch.stack(all_w, dim=1)


def gather_encode(table: torch.Tensor, xf: torch.Tensor, cfg: HashGridConfig,
                  levels: Optional[range] = None) -> torch.Tensor:
    """Plain corner gather + weighted sum: [M, dim] -> [M, L, F]; with
    `levels`, over that range of levels of a table that holds them alone."""
    idx, w = corner_indices_weights(xf, cfg, levels)
    feats = table[idx.flatten(1)].reshape(*idx.shape, table.shape[-1])
    return (feats * w[..., None]).sum(dim=2)


def gather_encode_bwd(g: torch.Tensor, xf: torch.Tensor, cfg: HashGridConfig,
                      n_rows: int, valid: Optional[torch.Tensor] = None,
                      levels: Optional[range] = None) -> torch.Tensor:
    """The table gradient [n_rows, F] of `gather_encode` for the cotangent
    g [M, L, F] (or [M, L*F]): one index_add_ of w * g over the 8 corners of
    every row and level (rows whose `valid` is false add nothing). `levels`
    as in `gather_encode`."""
    idx, w = corner_indices_weights(xf, cfg, levels)    # [M, L, 2^dim]
    f_dim = g.shape[-1] // (1 if g.dim() == 3 else idx.shape[1])
    g = g.reshape(xf.shape[0], idx.shape[1], f_dim)
    contrib = w[..., None] * g[:, :, None, :]           # [M, L, 2^dim, F]
    if valid is not None:
        contrib = torch.where(valid[:, None, None, None], contrib, 0.0)
    return g.new_zeros((n_rows, f_dim)).index_add_(
        0, idx.reshape(-1), contrib.reshape(-1, f_dim))


@dataclass(frozen=True)
class Backend:
    """One grid backend: `plain(table, xf, valid, cfg) -> [M, L, F]` is its
    plain PyTorch path; `kernel`, with the same signature, wraps its
    hand-written kernel (plain version on a CPU tensor, the kernel on a CUDA
    tensor), or is None for a backend that has no kernel; `check(cfg)`
    raises for configurations the backend does not take."""

    plain: Callable
    kernel: Optional[Callable]
    check: Callable[[HashGridConfig], None]

    @property
    def encode(self) -> Callable:
        return self.kernel or self.plain


def _takes_any(cfg: HashGridConfig):
    """The plain gather takes every gridtype, dimension and alignment."""


def _check_halo(cfg: HashGridConfig):
    if cfg.gridtype != "wrap" or cfg.input_dim != 3 or cfg.align_corners:
        raise ValueError("halo backend requires gridtype='wrap', "
                         "input_dim=3 and align_corners=False")


def lookup_indices(xf: torch.Tensor, cfg: HashGridConfig):
    """What the unfused branch hands the lookup kernel: (level-local rows
    [L, M*2^dim] int32, corner weights [M, L, 2^dim] f32). Every level is
    padded to T rows, so level l starts at row l*T."""
    idx, w = corner_indices_weights(xf, cfg)            # [M, L, 2^dim]
    offsets = torch.tensor([off for _, off, _, _, _ in cfg.level_params],
                           dtype=torch.int64, device=xf.device)
    idx_local = (idx - offsets[None, :, None]).permute(1, 0, 2) \
        .reshape(cfg.num_levels, -1).to(torch.int32)
    return idx_local, w


def lookup_encode(table: torch.Tensor, xf: torch.Tensor,
                  cfg: HashGridConfig) -> torch.Tensor:
    """The 'pallas' backend's unfused branch -> [M, L, F]: corner indices
    and weights here, level-local rows through the lookup kernel K5
    (ops/lookup.py), the weighted corner sum here."""
    from seal3d_tpu_torch.ops.lookup import multilevel_lookup

    m, levels = xf.shape[0], cfg.num_levels
    idx_local, w = lookup_indices(xf, cfg)
    vals = multilevel_lookup(table, idx_local)          # [L, M*2^dim, F]
    feats = vals.reshape(levels, m, 2**cfg.input_dim, table.shape[-1])
    out = (feats * w.permute(1, 0, 2)[..., None]).sum(dim=2)
    return out.permute(1, 0, 2)


def _fused_ok(cfg: HashGridConfig) -> bool:
    """Whether the 'pallas' backend takes its fused encode (K3)."""
    return cfg.input_dim == 3 and not cfg.align_corners


@cache
def backends() -> dict:
    """name -> Backend (built on first use: the kernel modules import this
    one)."""
    from seal3d_tpu_torch.ops import halo_encode as k1
    from seal3d_tpu_torch.ops import hash_encode as k3

    def hash_plain(table, xf, valid, cfg):
        return k3.hash_encode_plain(table, xf, cfg)

    def hash_kernel(table, xf, valid, cfg):
        return k3.hash_encode(table, xf, cfg)

    def pallas_kernel(table, xf, valid, cfg):
        if _fused_ok(cfg):
            return k3.hash_encode(table, xf, cfg)
        return lookup_encode(table, xf, cfg)

    return {
        "xla": Backend(lambda t, xf, v, c: gather_encode(t, xf, c), None,
                       _takes_any),
        "halo": Backend(k1.halo_encode_plain, k1.halo_encode, _check_halo),
        "pallas": Backend(hash_plain, pallas_kernel, _takes_any),
        "bucket": Backend(hash_plain, hash_kernel, _takes_any),
    }


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode positions: table [total_params, F], x [..., dim] in [0, 1] ->
    [..., L*F] level-major features. F is table.shape[-1] (stacked tables
    widen it). `valid` zeroes invalid rows on the halo backend (the other
    backends ignore it and compute every row, as in the reference)."""
    dim = cfg.input_dim
    f_dim = table.shape[-1]
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, dim).to(torch.float32)
    if cfg.backend not in backends():
        raise ValueError(f"unknown grid backend {cfg.backend!r}")
    backend = backends()[cfg.backend]
    backend.check(cfg)
    vf = None if valid is None else valid.reshape(-1)
    mesh = _model_mesh(cfg)
    if mesh is not None:
        out = encode_level_shard(table, xf, vf, cfg, mesh)
    else:
        out = backend.encode(table, xf, vf, cfg)
    return out.reshape(*batch_shape, cfg.num_levels * f_dim)


def _model_mesh(cfg: HashGridConfig):
    """The ambient mesh where `cfg` encodes level-sharded across ranks
    (shard_levels on the 'xla' or 'halo' backend under a mesh whose 'model'
    axis has more than one rank), else None. Without one, shard_levels
    encodes the uniform [L*T, F] stack whole, as the reference does without
    an ambient mesh; the 'pallas' and 'bucket' backends ignore it there
    too."""
    if not cfg.shard_levels or cfg.backend not in ("xla", "halo"):
        return None
    from seal3d_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return mesh if mesh is not None and mesh.size("model") > 1 else None


def encode_level_shard(table: torch.Tensor, xf: torch.Tensor,
                       valid: Optional[torch.Tensor], cfg: HashGridConfig,
                       mesh) -> torch.Tensor:
    """The level-sharded tensor-parallel encode on model rank j of `mesh`:
    table [L/n_model * T, F] holds levels [j*L/n, (j+1)*L/n) of the uniform
    stack; they are encoded on this rank's rows (K1 over the range on
    'halo', the plain gather on 'xla') and the features exchanged over
    'model' -> [M, L, F], differentiable in `table` (its gradient is this
    rank's levels only)."""
    from seal3d_tpu_torch.ops import halo_encode as k1
    from seal3d_tpu_torch.parallel.mesh import gather_model

    n_model, j = mesh.size("model"), mesh.index("model")
    if cfg.num_levels % n_model:
        raise ValueError(f"num_levels={cfg.num_levels} must divide the mesh "
                         f"'model' axis (size {n_model}) for level sharding")
    per = cfg.num_levels // n_model
    if table.shape[0] != per * 2**cfg.log2_hashmap_size:
        raise ValueError(f"level-sharded encode: the table has "
                         f"{table.shape[0]} rows, not its shard's {per} "
                         f"levels of {2**cfg.log2_hashmap_size}")
    if cfg.backend == "halo":
        local = k1.halo_encode_levels(table, xf, valid, cfg, j * per, per)
    else:
        local = gather_encode(table, xf, cfg, range(j * per, (j + 1) * per))
    return gather_model(local, mesh, j * per, cfg.num_levels)


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


def convert_table_layout(table: torch.Tensor, cfg_src: HashGridConfig,
                         cfg_dst: HashGridConfig) -> torch.Tensor:
    """Re-pack a flat table between backend layouts (per-level offsets
    differ: xla and bucket size levels natively, 8-aligned; pallas and halo
    pad every level to T). Only valid at equal hashmap size and level
    geometry. Extra destination padding is zero-filled; truncated source
    padding was never addressed. Used by `.pth` import and export
    (train/checkpoint.py)."""
    if cfg_src.log2_hashmap_size != cfg_dst.log2_hashmap_size:
        raise ValueError("cannot convert between different hashmap sizes: "
                         f"{cfg_src.log2_hashmap_size} vs "
                         f"{cfg_dst.log2_hashmap_size}")
    parts = []
    for (r1, off1, n1, uh1, _), (r2, _, n2, uh2, _) in zip(
            cfg_src.level_params, cfg_dst.level_params):
        if r1 != r2 or uh1 != uh2:
            raise ValueError("level geometry mismatch")
        blk = table[off1:off1 + min(n1, n2)]
        if n2 > blk.shape[0]:
            blk = torch.cat([blk, blk.new_zeros((n2 - blk.shape[0],
                                                 table.shape[-1]))])
        parts.append(blk)
    return torch.cat(parts)


def hashgrid_tv_loss(table: torch.Tensor, cfg: HashGridConfig,
                     level: int = 0) -> torch.Tensor:
    """Total-variation regularizer on one dense level: the mean squared
    difference of neighbouring entries along each axis, summed over axes
    (the reference's analog of gridencoder's grad_total_variation)."""
    resolution, offset, _, use_hash, _ = cfg.level_params[level]
    if use_hash:
        raise ValueError("TV loss only defined on dense (tiled) levels")
    n = resolution**cfg.input_dim
    grid = table[offset:offset + n].reshape((resolution,) * cfg.input_dim
                                            + (-1,))
    tv = table.new_zeros(())
    for axis in range(cfg.input_dim):
        d = torch.diff(grid, dim=axis)
        tv = tv + (d * d).mean()
    return tv
