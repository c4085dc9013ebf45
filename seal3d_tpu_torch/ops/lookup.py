"""Kernel K5: per-level row lookup on explicit indices, forward and backward.

Replaces the Pallas kernel pair of the JAX package's
seal3d_tpu/ops/pallas/lookup.py: `multilevel_lookup` (forward
`_lookup_fwd_impl`, backward `_lookup_bwd`), which its 'pallas' grid backend
takes where the fused encode does not apply (`align_corners=True` or
`input_dim != 3`): corner indices and weights are computed outside, the
kernel only fetches rows. What it computes:

    out[l, p, :]               = table[l*T + idx[l, p], :]
    gtab[l*T + idx[l, p], :]  += g[l, p, :]            (backward)

The table is the port's flat fp32 master `[L*T, F]` with every level padded
to T rows (the 'pallas' layout of `HashGridConfig.level_params`), not the
TPU kernel's `[L, F, T/128, 128]` stack, and everything is fp32: the TPU
kernel rounds the table and the cotangent to bf16 (up to ~2e-2). Indices
get no gradient. An index outside [0, T) is an error in the plain version;
the CUDA kernels (csrc/lookup.cu) read zeros and add nothing for it.

`multilevel_lookup` is differentiable in the table through `_Lookup`; both
halves dispatch on the tensors' device: the plain version for CPU tensors,
the kernel for CUDA tensors (no fallback).
"""

from __future__ import annotations

import torch

from seal3d_tpu_torch.runtime.kernels import Kernel


def _rows(idx: torch.Tensor, t_rows: int) -> torch.Tensor:
    """Level-local idx [L, N] -> flat global rows [L*N] int64."""
    levels = idx.shape[0]
    base = torch.arange(levels, dtype=torch.int64, device=idx.device) * t_rows
    return (idx.to(torch.int64) + base[:, None]).reshape(-1)


def multilevel_lookup_plain(table: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5 forward: one index_select. table [L*T, F], idx
    [L, N] level-local -> [L, N, F]."""
    levels, n = idx.shape
    rows = _rows(idx, table.shape[0] // levels)
    return table.index_select(0, rows).reshape(levels, n, table.shape[-1])


def multilevel_lookup_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                                n_rows: int) -> torch.Tensor:
    """Plain PyTorch K5 backward: one index_add_ of the cotangent g
    [L, N, F] into a zero table gradient [n_rows, F]."""
    levels = idx.shape[0]
    f_dim = g.shape[-1]
    return g.new_zeros((n_rows, f_dim)).index_add_(
        0, _rows(idx, n_rows // levels), g.reshape(-1, f_dim))


class _Lookup(torch.autograd.Function):
    """K5 with a table gradient; idx gets none."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        if table.device.type == "cpu":
            return multilevel_lookup_plain(table, idx)
        return _launch_fwd(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return multilevel_lookup_bwd(g.contiguous(), idx, ctx.n_rows), None


def _check_shapes(n_rows: int, idx: torch.Tensor):
    if idx.dim() != 2 or idx.shape[0] < 1 or n_rows % idx.shape[0]:
        raise ValueError(f"multilevel_lookup needs idx [L, N] and a table of "
                         f"L equal levels; got idx {tuple(idx.shape)}, "
                         f"{n_rows} rows")


def multilevel_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5 forward -> [L, N, F] f32, differentiable in `table`. table
    [L*T, F] f32, idx [L, N] int32 rows in [0, T) of each level. CPU tensors
    take the plain version; CUDA tensors launch the kernel (counted in
    `multilevel_lookup.launches`)."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"multilevel_lookup: unsupported device "
                         f"{table.device}")
    _check_shapes(table.shape[0], idx)
    return _Lookup.apply(table, idx)


def multilevel_lookup_bwd(g: torch.Tensor, idx: torch.Tensor,
                          n_rows: int) -> torch.Tensor:
    """K5 backward -> table gradient [n_rows, F] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    `multilevel_lookup_bwd.launches`)."""
    _check_shapes(n_rows, idx)
    if g.device.type == "cpu":
        return multilevel_lookup_bwd_plain(g, idx, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"multilevel_lookup_bwd: unsupported device "
                         f"{g.device}")
    return _launch_bwd(g, idx, n_rows)


multilevel_lookup.launches = 0
multilevel_lookup_bwd.launches = 0


# table | cotangent, idx, out | gtab, L, N, T, F, stream
_FWD = Kernel("multilevel_lookup_fwd", "ppp ill i s")
_BWD = Kernel("multilevel_lookup_bwd", "ppp ill i s")


def _run(kernel, a, idx, out, t_rows, f_dim, counter):
    dev = a.device
    if (idx.device != dev or idx.dtype != torch.int32
            or not idx.is_contiguous()):
        raise ValueError(f"multilevel_lookup idx must be a contiguous int32 "
                         f"[L, N] tensor on {dev}; got {idx.dtype} on "
                         f"{idx.device}")
    if (a.dtype != torch.float32 or f_dim not in (2, 4)
            or not a.is_contiguous() or a.data_ptr() % (4 * f_dim)):
        raise ValueError(f"multilevel_lookup needs contiguous, aligned f32 "
                         f"rows of width 2 or 4; got {a.dtype} "
                         f"{tuple(a.shape)}")
    kernel.launch(counter, a, idx, out, *idx.shape, t_rows, f_dim)


def _launch_fwd(table, idx):
    levels, n = idx.shape
    f_dim = table.shape[-1] if table.dim() == 2 else 0
    out = torch.empty((levels, n, f_dim), dtype=torch.float32,
                      device=table.device)
    if n == 0:
        return out
    _run(_FWD, table, idx, out, table.shape[0] // levels, f_dim,
         multilevel_lookup)
    return out


def _launch_bwd(g, idx, n_rows):
    levels, n = idx.shape
    f_dim = g.shape[-1]
    if g.shape != (levels, n, f_dim):
        raise ValueError(f"multilevel_lookup_bwd needs a cotangent "
                         f"[{levels}, {n}, F]; got {tuple(g.shape)}")
    gtab = torch.zeros((n_rows, f_dim), dtype=torch.float32, device=g.device)
    if n == 0:
        return gtab
    _run(_BWD, g, idx, gtab, n_rows // levels, f_dim, multilevel_lookup_bwd)
    return gtab
