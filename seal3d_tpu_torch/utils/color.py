"""sRGB <-> linear conversion (port of seal3d_tpu/utils/color.py)."""

from __future__ import annotations

import torch


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))
    return torch.where(x < 0.0031308, 12.92 * x,
                       1.055 * x ** (1.0 / 2.4) - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
