"""Teacher-side rendering (port of seal3d_tpu/seal/renderer.py): the proxy
remapping of field queries and the occupancy hacks.

- `make_teacher_field` wraps a field module so that every query is remapped
  through the mapper before evaluation and recoloured after; a secondary
  teacher can answer the mapped region (cross-scene editing). The renderer
  is functional, so the teacher is just another field module + params.
- `force_fill_cells` / `cells_to_byte_masks` / `hack_bitfield` precompute
  the Morton cells covering the edit region and force their occupancy bits
  on, so that marching samples the (initially empty) edit target; a
  bitfield made by `occupancy_update` is hacked again after each refresh.
"""

from __future__ import annotations

import numpy as np
import torch

from seal3d_tpu_torch.ops.bitfield import GRID_CELLS, GRID_SIZE
from seal3d_tpu_torch.ops.morton import morton3d
from seal3d_tpu_torch.seal.mappers import SealMapper, map_color, map_to_origin


def make_teacher_field(base_field, mapper: SealMapper, base_cfg,
                       secondary_field=None, secondary_cfg=None,
                       secondary_params=None):
    """A field-module-compatible namespace whose queries run through the
    mapper. `params` stays the base (frozen teacher) params; a secondary
    teacher, if given, answers the mapped region."""

    class TeacherField:
        @staticmethod
        def apply(params, cfg, x, d, valid=None):
            xm, dm, mask = map_to_origin(mapper, x, d)
            sigma, rgb = base_field.apply(params, cfg, xm, dm, valid=valid)
            if secondary_field is not None:
                s2, r2 = secondary_field.apply(secondary_params,
                                               secondary_cfg, xm, dm,
                                               valid=valid)
                sigma = torch.where(mask, s2, sigma)
                rgb = torch.where(mask[:, None], r2, rgb)
            rgb_mod = map_color(mapper, xm, dm, rgb, mask=mask)
            return sigma, torch.where(mask[:, None], rgb_mod, rgb)

        @staticmethod
        def density(params, cfg, x):
            xm, _, mask = map_to_origin(mapper, x, None)
            out = base_field.density(params, cfg, xm)
            if secondary_field is not None:
                out2 = secondary_field.density(secondary_params,
                                               secondary_cfg, xm)
                out = {"sigma": torch.where(mask, out2["sigma"], out["sigma"]),
                       "geo_feat": out["geo_feat"]}
            return out

        @staticmethod
        def color(params, cfg, x, d, geo_feat):
            xm, dm, mask = map_to_origin(mapper, x, d)
            rgb = base_field.color(params, cfg, xm, dm, geo_feat)
            rgb_mod = map_color(mapper, xm, dm, rgb, mask=mask)
            return torch.where(mask[:, None], rgb_mod, rgb)

    return TeacherField


def force_fill_cells(bounds: np.ndarray, cascades: int,
                     bound: float) -> np.ndarray:
    """Host-side: the flat (cascade, Morton) ids [K] int64 of every cell of
    the [C * H^3] grid that intersects any of the world AABBs `bounds`
    [B, 2, 3]."""
    bounds = np.asarray(bounds, np.float32).reshape(-1, 2, 3)
    cells = []
    for cas in range(cascades):
        b = min(float(2**cas), float(bound))
        for lo, hi in bounds:
            g_lo = np.floor((lo / b * 0.5 + 0.5) * GRID_SIZE).astype(np.int64)
            g_hi = np.ceil((hi / b * 0.5 + 0.5) * GRID_SIZE).astype(np.int64)
            g_lo = np.clip(g_lo, 0, GRID_SIZE - 1)
            g_hi = np.clip(g_hi, 1, GRID_SIZE)
            axes = [np.arange(g_lo[d], g_hi[d]) for d in range(3)]
            if any(len(a) == 0 for a in axes):
                continue
            coords = np.stack(np.meshgrid(*axes, indexing="ij"), -1) \
                .reshape(-1, 3)
            codes = morton3d(torch.from_numpy(coords)).numpy()
            cells.append(cas * GRID_CELLS + codes.astype(np.int64))
    if not cells:
        return np.zeros((0,), np.int64)
    return np.unique(np.concatenate(cells))


def cells_to_byte_masks(cells: np.ndarray):
    """Host-side: flat cell ids -> unique (byte index [U] int32, OR-mask [U]
    uint8) pairs, so the device-side hack is a duplicate-free scatter."""
    cells = np.asarray(cells, np.int64)
    byte_idx = cells >> 3
    bit = (1 << (cells & 7)).astype(np.uint8)
    uniq, inv = np.unique(byte_idx, return_inverse=True)
    masks = np.zeros(len(uniq), np.uint8)
    np.bitwise_or.at(masks, inv, bit)
    return uniq.astype(np.int32), masks


def hack_bitfield(bitfield: torch.Tensor, byte_idx: torch.Tensor,
                  masks: torch.Tensor) -> torch.Tensor:
    """A copy of the bitfield with the edit-region cells OR-ed in;
    `byte_idx` (int64) / `masks` come from cells_to_byte_masks."""
    if byte_idx.shape[0] == 0:
        return bitfield
    out = bitfield.clone()
    out[byte_idx] = bitfield[byte_idx] | masks
    return out


def hack_grid(density_grid: torch.Tensor, cells: torch.Tensor,
              value: float = 64.0) -> torch.Tensor:
    """A copy of the density grid with the edit-region cells (unique flat
    ids) raised to at least `value`."""
    if cells.shape[0] == 0:
        return density_grid
    flat = density_grid.reshape(-1).clone()
    flat[cells] = flat[cells].clamp(min=value)
    return flat.reshape(density_grid.shape)
