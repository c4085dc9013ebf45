"""Sin/cos positional (frequency) encoding (port of seal3d_tpu/ops/freq.py):
out = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^{F-1} x), cos(2^{F-1} x)],
its gradient by autograd."""

from __future__ import annotations

import torch


def freq_encode(x: torch.Tensor, degree: int = 12) -> torch.Tensor:
    """[..., D] -> [..., D * (1 + 2 * degree)]; each sin / cos block covers
    all D input dims."""
    outs = [x]
    for f in range(degree):
        xf = x * (2.0**f)
        outs.append(torch.sin(xf))
        outs.append(torch.cos(xf))
    return torch.cat(outs, dim=-1)


def freq_encode_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)
