"""Occupancy bitfield pack/lookup (port of seal3d_tpu/ops/bitfield.py).

Same layout as the reference: Morton-ordered cells, cascade-major, bit b of
byte i covers cell 8*i+b.
"""

from __future__ import annotations

import torch

GRID_SIZE = 128
GRID_CELLS = GRID_SIZE**3  # 2**21 cells per cascade
GRID_BYTES = GRID_CELLS // 8


def packbits(density_grid: torch.Tensor, thresh) -> torch.Tensor:
    """[C, H^3] Morton-ordered densities -> [C*H^3/8] uint8 bitfield
    (bit set iff density > thresh; negative = untrained, never set)."""
    occ = (density_grid.reshape(-1, 8) > thresh).to(torch.int32)
    bits = 1 << torch.arange(8, dtype=torch.int32, device=occ.device)
    return (occ * bits).sum(-1).to(torch.uint8)


def bitfield_lookup(bitfield: torch.Tensor, cascade: torch.Tensor,
                    morton: torch.Tensor) -> torch.Tensor:
    """Occupancy bit of (cascade, Morton cell) queries -> [...] bool."""
    cell = cascade.to(torch.int64) * GRID_CELLS + morton.to(torch.int64)
    byte = bitfield[cell >> 3].to(torch.int64)
    return ((byte >> (cell & 7)) & 1).to(torch.bool)
