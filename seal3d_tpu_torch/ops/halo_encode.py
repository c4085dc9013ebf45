"""Kernel K1: the forward of the 'halo' backend's hash-grid encode.

Replaces the Pallas kernel `halo_encode_fused` (seal3d_tpu/ops/pallas/
halo_encode.py, `_make_fwd_kernel` / `_fwd_impl_arrs`). What it computes, per
sample m and level l of a 'wrap' grid with T = P^3 entries per level:

    pos   = clamp(x * scale_l + 0.5, 0, res_l - 1),  pos0 = floor(pos)
    c     = min(pos0 + corner, res_l - 1) & (P - 1)        (8 corners)
    out[m, l*F + f] = sum_corner w_corner * table[l*T + (cx*P + cy)*P + cz, f]

with zeros for rows whose `valid` is false. The TPU kernel's halo row layout,
one-hot MXU fetch and bf16 stack existed because a TPU has no gather; the
CUDA kernel (csrc/halo_encode.cu) gathers straight from the fp32 [L*T, F]
master table and computes in fp32, so it differs from the reference kernel
by the reference's bf16 rounding (up to ~2e-2) and from the plain version
below only by summation order.

`halo_encode` dispatches on the tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors (no fallback). No gradient yet: K1's
backward belongs to the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from seal3d_tpu_torch.ops.hashgrid import HashGridConfig, gather_encode


def halo_encode_plain(table: torch.Tensor, x: torch.Tensor,
                      valid: Optional[torch.Tensor],
                      cfg: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch K1: corner gather + weighted sum, autograd-differentiable.
    table [L*T, F], x [M, 3] in [0, 1], valid [M] bool or None -> [M, L, F]."""
    out = gather_encode(table, x, cfg)
    if valid is not None:
        out = torch.where(valid[:, None, None], out, 0.0)
    return out


def halo_encode(table: torch.Tensor, x: torch.Tensor,
                valid: Optional[torch.Tensor],
                cfg: HashGridConfig) -> torch.Tensor:
    """K1 forward -> [M, L, F] f32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in `halo_encode.launches`)."""
    if table.device.type == "cpu":
        return halo_encode_plain(table, x, valid, cfg)
    if table.device.type != "cuda":
        raise ValueError(f"halo_encode: unsupported device {table.device}")
    return _launch(table, x, valid, cfg)


halo_encode.launches = 0


@functools.cache
def _level_arrays(cfg: HashGridConfig):
    scales = np.asarray([s for *_, s in cfg.level_params], np.float32)
    res = np.asarray([r for r, *_ in cfg.level_params], np.int32)
    return scales, res


@functools.cache
def _entry():
    from seal3d_tpu_torch.runtime.build import load_library

    fn = load_library().halo_encode_fwd
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i64, i32, i32, i32, i64, p, p, i32, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(table, x, valid, cfg):
    levels = cfg.num_levels
    t_rows = 2**cfg.log2_hashmap_size
    period = round(t_rows ** (1 / 3))
    f_dim = table.shape[-1] if table.dim() == 2 else 0
    if cfg.backend != "halo" or cfg.gridtype != "wrap" or cfg.input_dim != 3:
        raise ValueError("K1 needs a halo/wrap config with input_dim 3")
    if period**3 != t_rows or period & (period - 1) or levels > 32:
        raise ValueError(f"K1 needs T = P^3 with P a power of two and <= 32 "
                         f"levels (T={t_rows}, L={levels})")
    if cfg.interpolation not in ("linear", "smoothstep"):
        raise ValueError(f"unknown interpolation {cfg.interpolation!r}")
    if (table.dtype != torch.float32 or f_dim not in (2, 4)
            or table.shape[0] != levels * t_rows or not table.is_contiguous()
            or table.data_ptr() % (4 * f_dim)):
        raise ValueError(f"K1 table must be a contiguous, aligned f32 "
                         f"[{levels * t_rows}, 2|4] tensor; got "
                         f"{table.dtype} {tuple(table.shape)}")
    if (x.device != table.device or x.dtype != torch.float32 or x.dim() != 2
            or x.shape[1] != 3 or not x.is_contiguous()):
        raise ValueError(f"K1 x must be a contiguous f32 [M, 3] tensor on "
                         f"{table.device}; got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    m = x.shape[0]
    if valid is not None and (valid.device != table.device
                              or valid.dtype != torch.bool
                              or valid.shape != (m,)
                              or not valid.is_contiguous()):
        raise ValueError("K1 valid must be a contiguous bool [M] tensor on "
                         "the table's device")
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError(
            "K1 has no backward yet (ROADMAP.md Queue 1, 'Train step'); call "
            "it under torch.no_grad() or on a table without requires_grad")
    out = torch.empty((m, levels, f_dim), dtype=torch.float32,
                      device=table.device)
    if m == 0:
        return out
    scales, res = _level_arrays(cfg)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(x.data_ptr(), None if valid is None else valid.data_ptr(),
                      table.data_ptr(), out.data_ptr(), m, levels, f_dim,
                      period, t_rows, scales.ctypes.data, res.ctypes.data,
                      int(cfg.interpolation == "smoothstep"), stream)
    if rc != 0:
        raise RuntimeError(f"halo_encode_fwd launch failed: CUDA error {rc}")
    halo_encode.launches += 1
    return out
