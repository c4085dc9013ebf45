"""Vectorized RGB <-> HSV / HSL and the colour-edit helpers `modify_hsv` and
`modify_rgb` (port of seal3d_tpu/seal/color.py), on [..., 3] tensors."""

from __future__ import annotations

from typing import Optional

import torch


def _select6(i: torch.Tensor, choices) -> torch.Tensor:
    """choices[i] elementwise for sextant indices i in 0..5."""
    return torch.gather(torch.stack(choices, dim=-1), -1, i[..., None])[..., 0]


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] -> (h, s, v), h in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    safe = delta.clamp(min=1e-12)
    hr = torch.remainder((g - b) / safe, 6.0)
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)) / 6.0
    h = torch.where(delta > 0, h, 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h = torch.remainder(hsv[..., 0], 1.0)
    s = hsv[..., 1].clamp(0, 1)
    v = hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int64) % 6
    return torch.stack([_select6(i, [v, q, p, p, t, v]),
                        _select6(i, [t, v, v, q, p, p]),
                        _select6(i, [p, p, t, v, v, q])], dim=-1)


def rgb_to_hsl(rgb: torch.Tensor) -> torch.Tensor:
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    l = (maxc + minc) * 0.5
    delta = maxc - minc
    s = torch.where(
        delta > 0, delta / (1.0 - (2 * l - 1.0).abs()).clamp(min=1e-12), 0.0)
    return torch.stack([rgb_to_hsv(rgb)[..., 0], s.clamp(0, 1), l], dim=-1)


def hsl_to_rgb(hsl: torch.Tensor) -> torch.Tensor:
    h = torch.remainder(hsl[..., 0], 1.0)
    s = hsl[..., 1].clamp(0, 1)
    l = hsl[..., 2]
    c = (1.0 - (2 * l - 1.0).abs()) * s
    hp = h * 6.0
    x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    i = hp.to(torch.int64) % 6
    z = torch.zeros_like(c)
    m = l - c * 0.5
    return torch.stack([_select6(i, [c, x, z, z, x, c]) + m,
                        _select6(i, [x, c, c, x, z, z]) + m,
                        _select6(i, [z, z, x, c, c, x]) + m], dim=-1)


def modify_hsv(rgb: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
    """Shift colours in HSV space."""
    return hsv_to_rgb(rgb_to_hsv(rgb) + mod).clamp(0.0, 1.0)


def modify_rgb(rgb: torch.Tensor, target_rgb: torch.Tensor,
               light_offset=0.0,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Recolour keeping each point's lightness variation around the mean: H
    and S from the target colour, V = target V + (point V - mean V) +
    offset. `mask` (bool [...]) restricts the V mean to edit-region samples,
    so it does not drift with what else a render chunk holds."""
    hsv = rgb_to_hsv(rgb)
    target = rgb_to_hsv(torch.broadcast_to(
        torch.as_tensor(target_rgb, dtype=rgb.dtype, device=rgb.device),
        rgb.shape))
    if mask is None:
        v_mean = hsv[..., 2].mean()
    else:
        m = mask.to(hsv.dtype)
        v_mean = (hsv[..., 2] * m).sum() / m.sum().clamp(min=1.0)
    v = (target[..., 2] + (hsv[..., 2] - v_mean) + light_offset).clamp(0.0, 1.0)
    out = torch.stack([target[..., 0], target[..., 1], v], dim=-1)
    return hsv_to_rgb(out).clamp(0.0, 1.0)
