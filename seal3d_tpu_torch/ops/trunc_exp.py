"""Truncated-gradient exponential (port of seal3d_tpu/ops/trunc_exp.py):
forward exp(x), backward g * exp(clamp(x, -15, 15))."""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
