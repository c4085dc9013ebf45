"""30-bit 3D Morton (Z-order) codes (port of seal3d_tpu/ops/morton.py).

torch has no general uint32 arithmetic, so codes live in int64 tensors; every
intermediate stays below 2^32 after its mask, so the bits equal the uint32
reference exactly.
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value out to every 3rd bit."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _compress_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of _expand_bits: gather every 3rd bit back into the low 10."""
    v = v.to(torch.int64) & 0x49249249
    v = (v ^ (v >> 2)) & 0xC30C30C3
    v = (v ^ (v >> 4)) & 0x0F00F00F
    v = (v ^ (v >> 8)) & 0xFF0000FF
    v = (v ^ (v >> 16)) & 0x0000FFFF
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer grid coords (0..1023) -> [...] int64 Morton codes."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return x | (y << 1) | (z << 2)


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """[...] Morton codes -> [..., 3] int64 grid coords."""
    codes = codes.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_compress_bits(codes), _compress_bits(codes >> 1),
                        _compress_bits(codes >> 2)], dim=-1)
