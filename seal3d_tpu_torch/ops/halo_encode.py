"""Kernel K1: the 'halo' backend's hash-grid encode, forward and backward,
over all levels or over a range of them.

Replaces the Pallas kernel `halo_encode_fused` (seal3d_tpu/ops/pallas/
halo_encode.py): its forward (`_fwd_impl_arrs`, `_make_fwd_kernel`) and its
backward (`_bwd` -> `_bwd_impl`, `_make_bwd_kernel`), and the per-shard
program of `halo_encode_sharded` (`_halo_encode_arrs`: the same kernels over
a shard's levels). What it computes, per sample m and level l of a 'wrap'
grid with T = P^3 entries per level:

    pos   = clamp(x * scale_l + 0.5, 0, res_l - 1),  pos0 = floor(pos)
    c     = min(pos0 + corner, res_l - 1) & (P - 1)        (8 corners)
    out[m, l*F + f] = sum_corner w_corner * table[l*T + (cx*P + cy)*P + cz, f]

with zeros for rows whose `valid` is false; the backward scatters
gtab[l*T + row_c, f] += w_c * g[m, l*F + f] over every valid row, level and
corner, and gives x no gradient. The TPU kernels' halo row layout, one-hot
MXU fetch and scatter and bf16 stack existed because a TPU has no gather;
the CUDA kernels (csrc/halo_encode.cu) gather from and scatter into the fp32
[L*T, F] master table directly and compute in fp32, so they differ from the
reference kernels by the reference's bf16 rounding (up to ~2e-2) and from
the plain versions below only by summation order.

`halo_encode` and `halo_encode_levels` are differentiable in the table
through `_HaloEncode`. Both of its halves dispatch on the tensors' device:
the plain version for CPU tensors, the kernel for CUDA tensors (no fallback).
`halo_encode_sharded` is the single-device form of the reference's
level-sharded tensor-parallel encode: it runs every shard's program on this
device, one after another, and is the plain reference of the multi-rank
form. That form is `hashgrid.encode_level_shard` under a 'data' x 'model'
mesh (parallel/mesh.py): each rank runs `halo_encode_levels` on its rows
and levels, the features are exchanged over 'model' and the table
gradients summed over 'data' by the trainer.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, gather_encode,
                                           gather_encode_bwd)
from seal3d_tpu_torch.runtime.kernels import Kernel


def _level_range(cfg: HashGridConfig, level_begin: int,
                 level_count: int) -> range:
    if not (0 <= level_begin and 1 <= level_count
            and level_begin + level_count <= cfg.num_levels):
        raise ValueError(f"levels [{level_begin}, {level_begin + level_count})"
                         f" are not a range of the {cfg.num_levels} levels")
    return range(level_begin, level_begin + level_count)


def halo_encode_plain(table: torch.Tensor, x: torch.Tensor,
                      valid: Optional[torch.Tensor], cfg: HashGridConfig,
                      levels: Optional[range] = None) -> torch.Tensor:
    """Plain PyTorch K1 forward: corner gather + weighted sum.
    table [L*T, F], x [M, 3] in [0, 1], valid [M] bool or None -> [M, L, F].
    With `levels`, table holds that range's levels alone ([n*T, F]) and the
    result is [M, n, F]."""
    out = gather_encode(table, x, cfg, levels)
    if valid is not None:
        out = torch.where(valid[:, None, None], out, 0.0)
    return out


def halo_encode_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                          valid: Optional[torch.Tensor], cfg: HashGridConfig,
                          n_rows: int,
                          levels: Optional[range] = None) -> torch.Tensor:
    """Plain PyTorch K1 backward: the table gradient [n_rows, F] of the
    cotangent g [M, L, F] (or [M, L*F]), one index_add_ of w * g over the 8
    corners of every valid row and level. `levels` as in the forward."""
    return gather_encode_bwd(g, x, cfg, n_rows, valid, levels)


class _HaloEncode(torch.autograd.Function):
    """K1 over the levels `levels` with a table gradient; x, valid and the
    rest get none. `counter` is the public wrapper whose launches this call
    counts as."""

    @staticmethod
    def forward(ctx, table, x, valid, cfg, levels, counter):
        ctx.save_for_backward(x, valid)
        ctx.args = (cfg, table.shape[0], levels,
                    halo_encode_bwd if counter is halo_encode else counter)
        if table.device.type == "cpu":
            return halo_encode_plain(table, x, valid, cfg, levels)
        return _launch_fwd(table, x, valid, cfg, levels, None, counter)

    @staticmethod
    def backward(ctx, g):
        x, valid = ctx.saved_tensors
        cfg, n_rows, levels, counter = ctx.args
        if g.device.type == "cpu":
            gtab = halo_encode_bwd_plain(g, x, valid, cfg, n_rows, levels)
        else:
            gtab = _launch_bwd(g, x, valid, cfg, n_rows, levels, counter)
        return gtab, None, None, None, None, None


def _check_device(name: str, t: torch.Tensor):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def halo_encode(table: torch.Tensor, x: torch.Tensor,
                valid: Optional[torch.Tensor],
                cfg: HashGridConfig) -> torch.Tensor:
    """K1 forward -> [M, L, F] f32, differentiable in `table`. CPU tensors
    take the plain version; CUDA tensors launch the kernel (counted in
    `halo_encode.launches`)."""
    _check_device("halo_encode", table)
    return _HaloEncode.apply(table, x, valid, cfg, range(cfg.num_levels),
                             halo_encode)


def halo_encode_levels(table_levels: torch.Tensor, x: torch.Tensor,
                       valid: Optional[torch.Tensor], cfg: HashGridConfig,
                       level_begin: int, level_count: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 over the levels [level_begin, level_begin + level_count) of `cfg`:
    what one shard of the level-sharded encode runs. table_levels
    [level_count*T, F] holds those levels alone -> [M, level_count, F] f32,
    differentiable in `table_levels` (gradient [level_count*T, F]). CPU
    tensors take the plain version; CUDA tensors launch the kernels with the
    range's scales and resolutions (forward and backward launches counted in
    `halo_encode_levels.launches`).

    With `out` ([M, L, F] f32, contiguous, all L levels of `cfg`) the result
    is written into out[:, level_begin:level_begin + level_count] (the kernel
    takes the row stride) and that view is returned; no gradient is recorded
    through `out`, so the table must not require one."""
    _check_device("halo_encode_levels", table_levels)
    levels = _level_range(cfg, level_begin, level_count)
    if out is None:
        return _HaloEncode.apply(table_levels, x, valid, cfg, levels,
                                 halo_encode_levels)
    if table_levels.requires_grad and torch.is_grad_enabled():
        raise ValueError("halo_encode_levels: `out` records no gradient; "
                         "call without it for a table that requires one")
    f_dim = table_levels.shape[-1]
    if (out.shape != (x.shape[0], cfg.num_levels, f_dim)
            or out.dtype != torch.float32 or out.device != table_levels.device
            or not out.is_contiguous()):
        raise ValueError(f"halo_encode_levels: out must be a contiguous f32 "
                         f"[{x.shape[0]}, {cfg.num_levels}, {f_dim}] tensor "
                         f"on {table_levels.device}")
    view = out[:, levels.start:levels.stop]
    with torch.no_grad():
        if table_levels.device.type == "cpu":
            view.copy_(halo_encode_plain(table_levels, x, valid, cfg, levels))
        else:
            _launch_fwd(table_levels, x, valid, cfg, levels, view,
                        halo_encode_levels)
    return view


def halo_encode_bwd(g: torch.Tensor, x: torch.Tensor,
                    valid: Optional[torch.Tensor], cfg: HashGridConfig,
                    n_rows: int,
                    levels: Optional[range] = None) -> torch.Tensor:
    """K1 backward -> table gradient [n_rows, F] f32 of the cotangent g
    [M, n, F] or [M, n*F] (rows may be strided: a column block of a wider
    tensor). CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in `halo_encode_bwd.launches`, or, with a level range
    `levels`, in `halo_encode_levels.launches`)."""
    if g.device.type == "cpu":
        return halo_encode_bwd_plain(g, x, valid, cfg, n_rows, levels)
    if g.device.type != "cuda":
        raise ValueError(f"halo_encode_bwd: unsupported device {g.device}")
    if levels is None:
        return _launch_bwd(g, x, valid, cfg, n_rows, range(cfg.num_levels),
                           halo_encode_bwd)
    return _launch_bwd(g, x, valid, cfg, n_rows, levels, halo_encode_levels)


def halo_encode_sharded(master: torch.Tensor, x: torch.Tensor,
                        valid: Optional[torch.Tensor], cfg: HashGridConfig,
                        n_model: int, n_data: int) -> torch.Tensor:
    """The level-sharded tensor-parallel encode of the reference
    (`halo_encode_sharded` over a 'data' x 'model' mesh), all of its shards
    on this one device -> [M, L*F] f32, differentiable in `master`.

    master [L*T, F] splits its levels over `n_model` shards and x (with
    valid) its rows over `n_data`; shard (i, j) runs `halo_encode_levels`
    on rows i and levels j. Features concatenate over 'model' and rows over
    'data'; table gradients sum over 'data' (autograd accumulates them into
    the shard's slice of `master`). The multi-rank form
    (`hashgrid.encode_level_shard`) calls the same per-shard program on each
    rank and replaces the two concatenations and the sum by collectives."""
    levels, m = cfg.num_levels, x.shape[0]
    if levels % n_model != 0:
        raise ValueError(
            f"halo_encode_sharded: num_levels={levels} must divide the "
            f"mesh 'model' axis (size {n_model}) for level sharding.")
    if m % n_data != 0:
        raise ValueError(
            f"halo_encode_sharded: batch {m} must divide the "
            f"mesh 'data' axis (size {n_data}).")
    t_rows = 2**cfg.log2_hashmap_size
    per, rows = levels // n_model, m // n_data
    tables = [master[j * per * t_rows:(j + 1) * per * t_rows]
              for j in range(n_model)]
    blocks = []
    for i in range(n_data):
        xi = x[i * rows:(i + 1) * rows]
        vi = None if valid is None else valid[i * rows:(i + 1) * rows]
        blocks.append(torch.cat(
            [halo_encode_levels(tables[j], xi, vi, cfg, j * per, per)
             for j in range(n_model)], dim=1))
    return torch.cat(blocks, dim=0).reshape(m, levels * master.shape[-1])


halo_encode.launches = 0
halo_encode_bwd.launches = 0
halo_encode_levels.launches = 0


@functools.cache
def _level_arrays(cfg: HashGridConfig):
    scales = np.asarray([s for *_, s in cfg.level_params], np.float32)
    res = np.asarray([r for r, *_ in cfg.level_params], np.int32)
    return scales, res


# x, valid, table | cotangent, out | gtab, M, levels, F, P, T, scales,
# resolutions, smoothstep, stream, row stride of out | cotangent
_FWD = Kernel("halo_encode_fwd", "pppp liiil pp i s l")
_BWD = Kernel("halo_encode_bwd", "pppp liiil pp i s l")


def _check_inputs(device, x, valid, cfg):
    """Checks shared by both kernels -> (T, P)."""
    t_rows = 2**cfg.log2_hashmap_size
    period = round(t_rows ** (1 / 3))
    if cfg.backend != "halo" or cfg.gridtype != "wrap" or cfg.input_dim != 3:
        raise ValueError("K1 needs a halo/wrap config with input_dim 3")
    if period**3 != t_rows or period & (period - 1) or cfg.num_levels > 32:
        raise ValueError(f"K1 needs T = P^3 with P a power of two and <= 32 "
                         f"levels (T={t_rows}, L={cfg.num_levels})")
    if cfg.interpolation not in ("linear", "smoothstep"):
        raise ValueError(f"unknown interpolation {cfg.interpolation!r}")
    if (x.device != device or x.dtype != torch.float32 or x.dim() != 2
            or x.shape[1] != 3 or not x.is_contiguous()):
        raise ValueError(f"K1 x must be a contiguous f32 [M, 3] tensor on "
                         f"{device}; got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    if valid is not None and (valid.device != device
                              or valid.dtype != torch.bool
                              or valid.shape != (x.shape[0],)
                              or not valid.is_contiguous()):
        raise ValueError("K1 valid must be a contiguous bool [M] tensor on "
                         "the table's device")
    return t_rows, period


def _run(kernel, table_like, x, valid, feats, levels, f_dim, period, t_rows,
         cfg, counter):
    """Launch `kernel` over `levels`. `table_like` is the range's table
    (forward) or its gradient (backward); `feats` the [M, n, F] feature
    tensor (forward: out; backward: the cotangent), whose rows may be
    strided."""
    scales, res = _level_arrays(cfg)
    first = 4 * levels.start            # byte offset of the range's entries
    third, fourth = ((table_like, feats) if kernel is _FWD
                     else (feats, table_like))
    kernel.launch(counter, x, valid, third, fourth, x.shape[0], len(levels),
                  f_dim, period, t_rows, scales.ctypes.data + first,
                  res.ctypes.data + first,
                  int(cfg.interpolation == "smoothstep"),
                  feats.stride(0) if x.shape[0] > 1 else 0)


def _launch_fwd(table, x, valid, cfg, levels, out, counter):
    """Forward kernel over `levels` into `out` (an [M, n, F] view with dense
    inner dims) or a new tensor; counts on `counter.launches`."""
    t_rows, period = _check_inputs(table.device, x, valid, cfg)
    n = len(levels)
    f_dim = table.shape[-1] if table.dim() == 2 else 0
    if (table.dtype != torch.float32 or f_dim not in (2, 4)
            or table.shape[0] != n * t_rows or not table.is_contiguous()
            or table.data_ptr() % (4 * f_dim)):
        raise ValueError(f"K1 table must be a contiguous, aligned f32 "
                         f"[{n * t_rows}, 2|4] tensor; got "
                         f"{table.dtype} {tuple(table.shape)}")
    m = x.shape[0]
    if out is None:
        out = torch.empty((m, n, f_dim), dtype=torch.float32,
                          device=table.device)
    if m == 0:
        return out
    _run(_FWD, table, x, valid, out, levels, f_dim, period, t_rows, cfg,
         counter)
    return out


def _launch_bwd(g, x, valid, cfg, n_rows, levels, counter):
    t_rows, period = _check_inputs(g.device, x, valid, cfg)
    m, n = x.shape[0], len(levels)
    f_dim = g.shape[-1] // n if g.dim() == 2 else g.shape[-1]
    if (g.dtype != torch.float32 or f_dim not in (2, 4)
            or g.numel() != m * n * f_dim or g.shape[0] != m
            or n_rows != n * t_rows):
        raise ValueError(f"K1 backward needs an f32 cotangent [{m}, {n}, "
                         f"2|4] and n_rows {n * t_rows}; got {g.dtype} "
                         f"{tuple(g.shape)}, n_rows {n_rows}")
    if g.dim() == 2:
        g = g.unflatten(1, (n, f_dim))
    if (g.stride()[1:] != (f_dim, 1) or g.stride(0) % f_dim
            or g.stride(0) < n * f_dim or g.data_ptr() % (4 * f_dim)):
        g = g.contiguous()    # rows not dense, apart or aligned: one copy
    gtab = torch.zeros((n_rows, f_dim), dtype=torch.float32, device=g.device)
    if m == 0:
        return gtab
    _run(_BWD, gtab, x, valid, g, levels, f_dim, period, t_rows, cfg,
         counter)
    return gtab
