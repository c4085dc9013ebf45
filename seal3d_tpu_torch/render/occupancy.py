"""Multi-cascade occupancy grid maintenance (port of
seal3d_tpu/render/occupancy.py): `occupancy_init`, the full
`occupancy_update` and `mark_untrained`. The partial update (rotating slice +
occupied resamples) belongs to the training slice.

Randomness: the reference jitters each queried cell with `jax.random`; here
the jitter is either passed in (tests hand both packages the same numbers)
or drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from seal3d_tpu_torch.ops.bitfield import GRID_CELLS, GRID_SIZE, packbits
from seal3d_tpu_torch.ops.morton import morton3d_invert


class OccupancyState(NamedTuple):
    density_grid: torch.Tensor  # [C, H^3] f32, Morton order; -1 = untrained
    bitfield: torch.Tensor      # [C * H^3 / 8] uint8
    mean_density: torch.Tensor  # [] f32
    iter_density: torch.Tensor  # [] int32, number of updates so far
    mean_count: torch.Tensor    # [] f32, EMA of samples per batch
    occ_aabb: torch.Tensor      # [6] world AABB of occupied cells


def occupancy_init(cascades: int, device=None) -> OccupancyState:
    b = float(max(2 ** (cascades - 1), 1))
    kw = dict(device=device)
    return OccupancyState(
        density_grid=torch.zeros((cascades, GRID_CELLS), dtype=torch.float32, **kw),
        bitfield=torch.zeros((cascades * GRID_CELLS // 8,), dtype=torch.uint8, **kw),
        mean_density=torch.zeros((), dtype=torch.float32, **kw),
        iter_density=torch.zeros((), dtype=torch.int32, **kw),
        mean_count=torch.full((), -1.0, dtype=torch.float32, **kw),
        occ_aabb=torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, **kw),
    )


def _cell_coords(device) -> torch.Tensor:
    """[H^3, 3] f32 grid coords of every Morton cell."""
    codes = torch.arange(GRID_CELLS, dtype=torch.int64, device=device)
    return morton3d_invert(codes).to(torch.float32)


def occupancy_update(state: OccupancyState,
                     density_fn: Callable[[torch.Tensor], torch.Tensor],
                     bound: float, density_thresh: float = 0.01,
                     decay: float = 0.95,
                     jitter: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     query_chunk: int = 2**17) -> OccupancyState:
    """One full maintenance step: re-query every cell at a jittered position,
    EMA-max decay, threshold min(mean_density, density_thresh), repack.

    density_fn: [M, 3] world positions -> [M] sigma (density-scaled).
    jitter: [C, H^3, 3] in [0, 1), or None to draw it from `generator`.
    The reference's partial update (full=False) belongs to the training
    slice.
    """
    grid = state.density_grid
    cascades = grid.shape[0]
    dev = grid.device
    coords = _cell_coords(dev)
    new_vals = torch.empty_like(grid)
    for cas in range(cascades):
        jit = (jitter[cas] if jitter is not None else
               torch.rand(coords.shape, generator=generator, device=dev))
        b = min(float(2**cas), float(bound))
        xs = ((coords + jit) / GRID_SIZE * 2.0 - 1.0) * b
        for i in range(0, GRID_CELLS, query_chunk):
            new_vals[cas, i:i + query_chunk] = density_fn(xs[i:i + query_chunk])

    trained = grid >= 0.0
    grid = torch.where(trained, torch.maximum(grid * decay, new_vals), grid)
    mean_density = grid.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    bitfield = packbits(grid, thresh)

    # world AABB of occupied coarsest-cascade cells
    occ_any = (grid > thresh).any(0)
    b_last = min(float(2 ** (cascades - 1)), float(bound))
    world = (coords / GRID_SIZE * 2.0 - 1.0) * b_last
    cell = 2.0 * b_last / GRID_SIZE
    big = torch.full((3,), 1e9, dtype=torch.float32, device=dev)
    lo = torch.where(occ_any[:, None], world, big).amin(0) - cell
    hi = torch.where(occ_any[:, None], world, -big).amax(0) + 2 * cell
    fallback = torch.tensor([-b_last] * 3 + [b_last] * 3, dtype=torch.float32,
                            device=dev)
    occ_aabb = torch.where(occ_any.any(), torch.cat([lo, hi]), fallback)
    return OccupancyState(density_grid=grid, bitfield=bitfield,
                          mean_density=mean_density,
                          iter_density=state.iter_density + 1,
                          mean_count=state.mean_count, occ_aabb=occ_aabb)


def mark_untrained(state: OccupancyState, poses: torch.Tensor,
                   intrinsics: torch.Tensor, bound: float,
                   chunk: int = GRID_CELLS // 8) -> OccupancyState:
    """Set density -1 on cells whose center projects into no training
    camera's frustum (+5% slack). poses [B, 4, 4] camera-to-world, +z
    forward; intrinsics [4] (fx, fy, cx, cy)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    cam_pos = poses[:, :3, 3]
    rot = poses[:, :3, :3]
    unit = (_cell_coords(poses.device) + 0.5) / GRID_SIZE
    half_w = 1.05 * cx / fx
    half_h = 1.05 * cy / fy
    eps = 1e-6
    grid = state.density_grid.clone()
    for cas in range(grid.shape[0]):
        b = min(float(2**cas), float(bound))
        world = (unit * 2.0 - 1.0) * b
        vis = torch.empty(GRID_CELLS, dtype=torch.bool, device=poses.device)
        for i in range(0, GRID_CELLS, chunk):
            rel = world[i:i + chunk, None, :] - cam_pos[None, :, :]  # [n, B, 3]
            # world -> camera: R^T @ rel, as an explicit sum over i
            cam = (rot[None, :, 0, :] * rel[..., 0:1]
                   + rot[None, :, 1, :] * rel[..., 1:2]
                   + rot[None, :, 2, :] * rel[..., 2:3])             # [n, B, 3]
            z = cam[..., 2]
            zc = z.clamp(min=eps)
            ok = ((z > eps) & ((cam[..., 0] / zc).abs() < half_w)
                  & ((cam[..., 1] / zc).abs() < half_h))
            vis[i:i + chunk] = ok.any(dim=1)
        grid[cas] = torch.where(vis, grid[cas], -1.0)
    return state._replace(density_grid=grid)
