"""Kernels K3 and K2: the 'hash' gridtype's encode for the 'pallas' and
'bucket' backends, forward and backward.

Replaces two Pallas kernels of the JAX package:
- K3, `hash_encode_fused` (seal3d_tpu/ops/pallas/hash_encode.py), forward
  (`_fused_fwd_impl`) and backward (`_fused_bwd`): the 'pallas' backend,
  every level padded to T rows;
- K2, `bucket_scatter_add` (seal3d_tpu/ops/pallas/bucket_grad.py): the table
  gradient of the 'bucket' backend's gather (`_bucket_encode`,
  seal3d_tpu/ops/hashgrid.py), native 8-aligned level sizes.
What it computes, per sample m and level l with (offset_l, size_l, res_l,
use_hash_l, scale_l) from `HashGridConfig.level_params`:

    pos   = clamp(x * scale_l + 0.5, 0, res_l - 1),  pos0 = floor(pos)
    c     = min(pos0 + corner, res_l - 1)                       (8 corners)
    idx_c = (cx ^ cy*2654435761 ^ cz*805459861) & (size_l - 1)   hashed (uint32)
          = min(cx + cy*res_l + cz*res_l^2, size_l - 1)           dense
    out[m, l*F + f] = sum_c w_c * table[offset_l + idx_c, f]

and the backward scatters gtab[offset_l + idx_c, f] += w_c * g[m, l*F + f].
Like the reference's pallas and bucket backends, the encode ignores `valid`
(every row is computed). Positions get the gradient the reference gives
them: none on the fused 'pallas' backend (its `_fused_bwd` returns None),
and on 'bucket' the formula of its `_bucket_encode_bwd`: gw = g . (the
gathered corner features), pulled back through the interpolation weights'
derivative, dx = d/dx sum(w(x) * gw) (`bucket_dx`, plain PyTorch ops beside
K2, as the reference computes it in XLA beside its Pallas kernel). D-NeRF's
warp puts this gradient on a path.
The CUDA kernels (csrc/hash_encode.cu) gather from and scatter into the fp32
master table [total_params, F] directly and compute in fp32, so they differ
from K3 by its bf16 rounding (up to ~2e-2), and from the plain versions below
and from K2 only by summation order.

`hash_encode` is differentiable in the table through `_HashEncode`. Both of
its halves dispatch on the tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors (no fallback).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig,
                                           corner_indices_weights,
                                           gather_encode, gather_encode_bwd)
from seal3d_tpu_torch.runtime.kernels import Kernel


def hash_encode_plain(table: torch.Tensor, x: torch.Tensor,
                      cfg: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch K3/bucket forward: the corner gather over
    `corner_indices_weights` with the config's own level offsets.
    table [total_params, F], x [M, 3] in [0, 1] -> [M, L, F]."""
    return gather_encode(table, x, cfg)


def hash_encode_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                          cfg: HashGridConfig, n_rows: int) -> torch.Tensor:
    """Plain PyTorch K3 backward / K2: the table gradient [n_rows, F] of the
    cotangent g [M, L, F] (or [M, L*F]), one index_add_ of w * g."""
    return gather_encode_bwd(g, x, cfg, n_rows)


def bucket_dx(g: torch.Tensor, table: torch.Tensor, x: torch.Tensor,
              cfg: HashGridConfig) -> torch.Tensor:
    """The 'bucket' backend's position gradient [M, dim] for the cotangent
    g [M, L, F] (or [M, L*F]), as the reference's `_bucket_encode_bwd`
    computes it: gw [M, L, 2^dim] = g . (the corner rows of `table`), then
    the gradient of sum(w(x) * gw) through the interpolation weights alone
    (floor and the corner indices are constant in x). Plain PyTorch ops on
    either device."""
    idx, _ = corner_indices_weights(x, cfg)
    m, levels, corners = idx.shape
    feats = table[idx.reshape(m, -1)].reshape(m, levels, corners, -1)
    gw = torch.einsum("mlf,mlcf->mlc", g.reshape(m, levels, -1), feats)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        _, w = corner_indices_weights(xx, cfg)
        (dx,) = torch.autograd.grad((w * gw).sum(), xx)
    return dx


class _HashEncode(torch.autograd.Function):
    """K3 / bucket encode with a table gradient, and on 'bucket' the
    reference's position gradient (`bucket_dx`); cfg gets none."""

    @staticmethod
    def forward(ctx, table, x, cfg):
        ctx.save_for_backward(x, table)
        ctx.cfg = cfg
        ctx.n_rows = table.shape[0]
        if table.device.type == "cpu":
            return hash_encode_plain(table, x, cfg)
        return _launch_fwd(table, x, cfg)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g = g.contiguous()
        gtab = hash_encode_bwd(g, x, ctx.cfg, ctx.n_rows)
        dx = None
        if ctx.needs_input_grad[1] and ctx.cfg.backend == "bucket":
            dx = bucket_dx(g, table, x, ctx.cfg)
        return gtab, dx, None


def hash_encode(table: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """K3 / bucket forward -> [M, L, F] f32, differentiable in `table`, and
    on cfg.backend 'bucket' in `x` too (`bucket_dx`); the fused 'pallas'
    backend gives positions no gradient, as the reference does. CPU tensors
    take the plain version; CUDA tensors launch the kernel (counted in
    `hash_encode.launches`)."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_encode: unsupported device {table.device}")
    return _HashEncode.apply(table, x, cfg)


def hash_encode_bwd(g: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
                    n_rows: int) -> torch.Tensor:
    """K3 backward / K2 -> table gradient [n_rows, F] f32. CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted in
    `hash_encode_bwd.launches`)."""
    if g.device.type == "cpu":
        return hash_encode_bwd_plain(g, x, cfg, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"hash_encode_bwd: unsupported device {g.device}")
    return _launch_bwd(g, x, cfg, n_rows)


hash_encode.launches = 0
hash_encode_bwd.launches = 0


@functools.cache
def _level_arrays(cfg: HashGridConfig):
    """The layout as host arrays: offsets, sizes (int64), resolutions,
    hash flags (int32), scales (f32)."""
    lp = cfg.level_params
    return (np.asarray([o for _, o, _, _, _ in lp], np.int64),
            np.asarray([n for _, _, n, _, _ in lp], np.int64),
            np.asarray([r for r, _, _, _, _ in lp], np.int32),
            np.asarray([int(h) for _, _, _, h, _ in lp], np.int32),
            np.asarray([s for _, _, _, _, s in lp], np.float32))


# x, table | cotangent, out | gtab, M, L, F, total_params, offsets, sizes,
# resolutions, hash flags, scales, align_corners, smoothstep, stream
_FWD = Kernel("hash_encode_fwd", "ppp liil ppppp ii s")
_BWD = Kernel("hash_encode_bwd", "ppp liil ppppp ii s")


def _check_inputs(device, x, cfg, n_rows):
    """Checks shared by both kernels."""
    if cfg.gridtype != "hash" or cfg.input_dim != 3 or cfg.num_levels > 32:
        # K3 indexes non-hashed levels of 'tiled' grids unlike the xla and
        # bucket paths (ROADMAP.md Queue 3); the kernels take 'hash' only
        raise ValueError(f"the hash-encode kernels need gridtype 'hash', "
                         f"input_dim 3 and <= 32 levels; got "
                         f"{cfg.gridtype!r}, {cfg.input_dim}, "
                         f"{cfg.num_levels}")
    if cfg.interpolation not in ("linear", "smoothstep"):
        raise ValueError(f"unknown interpolation {cfg.interpolation!r}")
    if n_rows != cfg.total_params:
        raise ValueError(f"table rows {n_rows} != the config's total_params "
                         f"{cfg.total_params}")
    if (x.device != device or x.dtype != torch.float32 or x.dim() != 2
            or x.shape[1] != 3 or not x.is_contiguous()):
        raise ValueError(f"hash-encode x must be a contiguous f32 [M, 3] "
                         f"tensor on {device}; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _run(kernel, a, x, out, f_dim, cfg, counter):
    offsets, sizes, res, use_hash, scales = _level_arrays(cfg)
    kernel.launch(counter, x, a, out, x.shape[0], cfg.num_levels, f_dim,
                  cfg.total_params, offsets.ctypes.data, sizes.ctypes.data,
                  res.ctypes.data, use_hash.ctypes.data, scales.ctypes.data,
                  int(cfg.align_corners),
                  int(cfg.interpolation == "smoothstep"))


def _launch_fwd(table, x, cfg):
    _check_inputs(table.device, x, cfg, table.shape[0])
    f_dim = table.shape[-1] if table.dim() == 2 else 0
    if (table.dtype != torch.float32 or f_dim not in (2, 4)
            or not table.is_contiguous() or table.data_ptr() % (4 * f_dim)):
        raise ValueError(f"hash-encode table must be a contiguous, aligned "
                         f"f32 [{cfg.total_params}, 2|4] tensor; got "
                         f"{table.dtype} {tuple(table.shape)}")
    m = x.shape[0]
    out = torch.empty((m, cfg.num_levels, f_dim), dtype=torch.float32,
                      device=table.device)
    if m == 0:
        return out
    _run(_FWD, table, x, out, f_dim, cfg, hash_encode)
    return out


def _launch_bwd(g, x, cfg, n_rows):
    _check_inputs(g.device, x, cfg, n_rows)
    m, levels = x.shape[0], cfg.num_levels
    f_dim = g.shape[-1] // levels if g.dim() == 2 else g.shape[-1]
    if (g.dtype != torch.float32 or f_dim not in (2, 4)
            or g.numel() != m * levels * f_dim or g.shape[0] != m
            or not g.is_contiguous() or g.data_ptr() % (4 * f_dim)):
        raise ValueError(f"hash-encode backward needs a contiguous, aligned "
                         f"f32 cotangent [{m}, {levels}, 2|4]; got {g.dtype} "
                         f"{tuple(g.shape)}")
    gtab = torch.zeros((n_rows, f_dim), dtype=torch.float32, device=g.device)
    if m == 0:
        return gtab
    _run(_BWD, g, x, gtab, f_dim, cfg, hash_encode_bwd)
    return gtab
