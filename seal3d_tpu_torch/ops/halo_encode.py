"""Kernel K1: the 'halo' backend's hash-grid encode, forward and backward.

Replaces the Pallas kernel `halo_encode_fused` (seal3d_tpu/ops/pallas/
halo_encode.py): its forward (`_fwd_impl_arrs`, `_make_fwd_kernel`) and its
backward (`_bwd` -> `_bwd_impl`, `_make_bwd_kernel`). What it computes, per
sample m and level l of a 'wrap' grid with T = P^3 entries per level:

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

`halo_encode` is differentiable in the table through `_HaloEncode`. Both of
its halves dispatch on the tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors (no fallback).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, gather_encode,
                                           gather_encode_bwd)


def halo_encode_plain(table: torch.Tensor, x: torch.Tensor,
                      valid: Optional[torch.Tensor],
                      cfg: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch K1 forward: corner gather + weighted sum.
    table [L*T, F], x [M, 3] in [0, 1], valid [M] bool or None -> [M, L, F]."""
    out = gather_encode(table, x, cfg)
    if valid is not None:
        out = torch.where(valid[:, None, None], out, 0.0)
    return out


def halo_encode_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                          valid: Optional[torch.Tensor], cfg: HashGridConfig,
                          n_rows: int) -> torch.Tensor:
    """Plain PyTorch K1 backward: the table gradient [n_rows, F] of the
    cotangent g [M, L, F] (or [M, L*F]), one index_add_ of w * g over the 8
    corners of every valid row and level."""
    return gather_encode_bwd(g, x, cfg, n_rows, valid)


class _HaloEncode(torch.autograd.Function):
    """K1 with a table gradient; x, valid and cfg get none."""

    @staticmethod
    def forward(ctx, table, x, valid, cfg):
        ctx.save_for_backward(x, valid)
        ctx.cfg = cfg
        ctx.n_rows = table.shape[0]
        if table.device.type == "cpu":
            return halo_encode_plain(table, x, valid, cfg)
        return _launch_fwd(table, x, valid, cfg)

    @staticmethod
    def backward(ctx, g):
        x, valid = ctx.saved_tensors
        gtab = halo_encode_bwd(g.contiguous(), x, valid, ctx.cfg, ctx.n_rows)
        return gtab, None, None, None


def halo_encode(table: torch.Tensor, x: torch.Tensor,
                valid: Optional[torch.Tensor],
                cfg: HashGridConfig) -> torch.Tensor:
    """K1 forward -> [M, L, F] f32, differentiable in `table`. CPU tensors
    take the plain version; CUDA tensors launch the kernel (counted in
    `halo_encode.launches`)."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"halo_encode: unsupported device {table.device}")
    return _HaloEncode.apply(table, x, valid, cfg)


def halo_encode_bwd(g: torch.Tensor, x: torch.Tensor,
                    valid: Optional[torch.Tensor], cfg: HashGridConfig,
                    n_rows: int) -> torch.Tensor:
    """K1 backward -> table gradient [n_rows, F] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    `halo_encode_bwd.launches`)."""
    if g.device.type == "cpu":
        return halo_encode_bwd_plain(g, x, valid, cfg, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"halo_encode_bwd: unsupported device {g.device}")
    return _launch_bwd(g, x, valid, cfg, n_rows)


halo_encode.launches = 0
halo_encode_bwd.launches = 0


@functools.cache
def _level_arrays(cfg: HashGridConfig):
    scales = np.asarray([s for *_, s in cfg.level_params], np.float32)
    res = np.asarray([r for r, *_ in cfg.level_params], np.int32)
    return scales, res


@functools.cache
def _entry(name: str):
    from seal3d_tpu_torch.runtime.build import load_library

    fn = getattr(load_library(), name)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i64, i32, i32, i32, i64, p, p, i32, p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(device, x, valid, cfg):
    """Checks shared by both kernels -> (levels, T, P)."""
    levels = cfg.num_levels
    t_rows = 2**cfg.log2_hashmap_size
    period = round(t_rows ** (1 / 3))
    if cfg.backend != "halo" or cfg.gridtype != "wrap" or cfg.input_dim != 3:
        raise ValueError("K1 needs a halo/wrap config with input_dim 3")
    if period**3 != t_rows or period & (period - 1) or levels > 32:
        raise ValueError(f"K1 needs T = P^3 with P a power of two and <= 32 "
                         f"levels (T={t_rows}, L={levels})")
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
    return levels, t_rows, period


def _run(name, a, x, valid, out, levels, f_dim, period, t_rows, cfg):
    """Launch entry `name` on the current stream; raise on a CUDA error."""
    scales, res = _level_arrays(cfg)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(name)(x.data_ptr(),
                          None if valid is None else valid.data_ptr(),
                          a.data_ptr(), out.data_ptr(), x.shape[0], levels,
                          f_dim, period, t_rows, scales.ctypes.data,
                          res.ctypes.data,
                          int(cfg.interpolation == "smoothstep"), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _launch_fwd(table, x, valid, cfg):
    levels, t_rows, period = _check_inputs(table.device, x, valid, cfg)
    f_dim = table.shape[-1] if table.dim() == 2 else 0
    if (table.dtype != torch.float32 or f_dim not in (2, 4)
            or table.shape[0] != levels * t_rows or not table.is_contiguous()
            or table.data_ptr() % (4 * f_dim)):
        raise ValueError(f"K1 table must be a contiguous, aligned f32 "
                         f"[{levels * t_rows}, 2|4] tensor; got "
                         f"{table.dtype} {tuple(table.shape)}")
    m = x.shape[0]
    out = torch.empty((m, levels, f_dim), dtype=torch.float32,
                      device=table.device)
    if m == 0:
        return out
    _run("halo_encode_fwd", table, x, valid, out, levels, f_dim,
         period, t_rows, cfg)
    halo_encode.launches += 1
    return out


def _launch_bwd(g, x, valid, cfg, n_rows):
    levels, t_rows, period = _check_inputs(g.device, x, valid, cfg)
    m = x.shape[0]
    f_dim = g.shape[-1] // levels if g.dim() == 2 else g.shape[-1]
    if (g.dtype != torch.float32 or f_dim not in (2, 4)
            or g.numel() != m * levels * f_dim or g.shape[0] != m
            or not g.is_contiguous() or g.data_ptr() % (4 * f_dim)
            or n_rows != levels * t_rows):
        raise ValueError(f"K1 backward needs a contiguous, aligned f32 "
                         f"cotangent [{m}, {levels}, 2|4] and n_rows "
                         f"{levels * t_rows}; got {g.dtype} "
                         f"{tuple(g.shape)}, n_rows {n_rows}")
    gtab = torch.zeros((n_rows, f_dim), dtype=torch.float32, device=g.device)
    if m == 0:
        return gtab
    _run("halo_encode_bwd", g, x, valid, gtab, levels, f_dim, period,
         t_rows, cfg)
    halo_encode_bwd.launches += 1
    return gtab
