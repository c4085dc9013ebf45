"""Multi-cascade occupancy grid maintenance (port of
seal3d_tpu/render/occupancy.py): `occupancy_init`, `occupancy_update` (full,
or partial: a rotating strided slice plus occupied-cell resamples) and
`mark_untrained`; and the time-sliced grid of dynamic scenes (D-NeRF),
`occupancy_t_init` / `occupancy_t_update`.

Randomness: the reference draws the cell jitter and the occupied-cell
uniforms with `jax.random`; here they are either passed in (tests hand both
packages the same numbers) or drawn from an explicit `torch.Generator`.
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


def cell_world_positions(codes: torch.Tensor, cascade: int, bound: float,
                         jitter: torch.Tensor) -> torch.Tensor:
    """Morton codes [M] + jitter [M, 3] in [0, 1) -> world positions inside
    each cell of cascade c, which covers [-b_c, b_c]^3, b_c = min(2^c,
    bound)."""
    coords = morton3d_invert(codes).to(torch.float32)
    b = min(float(2**cascade), float(bound))
    return ((coords + jitter) / GRID_SIZE * 2.0 - 1.0) * b


def _sample_occupied(u: torch.Tensor, occ_mask: torch.Tensor) -> torch.Tensor:
    """Cell indices ~ uniform over occupied cells by inverse CDF, from
    uniforms u [n] in [0, 1)."""
    cdf = torch.cumsum(occ_mask.to(torch.float32), 0)
    idx = torch.searchsorted(cdf, u * cdf[-1].clamp(min=1.0), side="left")
    return idx.clamp(0, occ_mask.shape[0] - 1)


def occupancy_update(state: OccupancyState,
                     density_fn: Callable[[torch.Tensor], torch.Tensor],
                     bound: float, density_thresh: float = 0.01,
                     decay: float = 0.95, full: bool = True,
                     jitter: Optional[torch.Tensor] = None,
                     uniforms: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     partial_cells: int = GRID_CELLS // 8,
                     occ_cells: int = 2**16,
                     query_chunk: int = 2**17) -> OccupancyState:
    """One maintenance step: re-query cells at jittered positions, EMA-max
    decay, threshold min(mean_density, density_thresh), repack.

    full: every cell of every cascade; else per cascade a rotating strided
    slice of `partial_cells` cells (phase iter_density % stride, so 8 updates
    cover the grid) plus `occ_cells` resamples of occupied cells.
    density_fn: [M, 3] world positions -> [M] sigma (density-scaled).
    jitter: [C, Q, 3] in [0, 1) for the Q queried cells of each cascade
    (Q = H^3, or partial_cells + occ_cells); uniforms: [C, occ_cells] in
    [0, 1) for the occupied resamples (partial only). Either None draws it
    from `generator`.
    """
    grid = state.density_grid
    cascades = grid.shape[0]
    dev = grid.device

    def rand(shape, given, cas):
        return (given[cas] if given is not None else
                torch.rand(shape, generator=generator, device=dev))

    new_vals = torch.zeros_like(grid)
    written = torch.zeros_like(grid, dtype=torch.bool)
    stride = GRID_CELLS // partial_cells
    for cas in range(cascades):
        if full:
            codes = torch.arange(GRID_CELLS, dtype=torch.int64, device=dev)
        else:
            uni = (torch.arange(partial_cells, dtype=torch.int64, device=dev)
                   * stride + state.iter_density % stride)
            occ = _sample_occupied(rand((occ_cells,), uniforms, cas),
                                   grid[cas] > 0.0)
            codes = torch.cat([uni, occ])
        xs = cell_world_positions(codes, cas, bound,
                                  rand((codes.shape[0], 3), jitter, cas))
        vals = torch.cat([density_fn(xs[i:i + query_chunk])
                          for i in range(0, xs.shape[0], query_chunk)])
        if full:
            new_vals[cas] = vals
            written[cas] = True
        else:  # duplicate codes keep their largest value (.at[].max)
            new_vals[cas].scatter_reduce_(0, codes, vals, "amax")
            written[cas, codes] = True

    trained = grid >= 0.0
    decayed = torch.where(written, torch.maximum(grid * decay, new_vals), grid)
    grid = torch.where(trained, decayed, grid)
    mean_density = grid.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    bitfield = packbits(grid, thresh)

    # world AABB of occupied coarsest-cascade cells
    coords = _cell_coords(dev)
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


# ----------------------------------------------------- time-sliced (D-NeRF)

class OccupancyStateT(NamedTuple):
    """Occupancy of a dynamic scene, one grid per time slice: `.npz` keys
    `occ/density_grid` [T, C, H^3], `occ/bitfield` [T, C*H^3/8], as in the
    reference."""

    density_grid: torch.Tensor  # [T, C, H^3] f32
    bitfield: torch.Tensor      # [T, C * H^3 / 8] uint8
    mean_density: torch.Tensor  # [] f32
    iter_density: torch.Tensor  # [] int32


def occupancy_t_init(time_size: int, cascades: int,
                     device=None) -> OccupancyStateT:
    kw = dict(device=device)
    return OccupancyStateT(
        density_grid=torch.zeros((time_size, cascades, GRID_CELLS),
                                 dtype=torch.float32, **kw),
        bitfield=torch.zeros((time_size, cascades * GRID_CELLS // 8),
                             dtype=torch.uint8, **kw),
        mean_density=torch.zeros((), dtype=torch.float32, **kw),
        iter_density=torch.zeros((), dtype=torch.int32, **kw))


def occupancy_t_update(state: OccupancyStateT, density_fn,
                       bound: float, t_indices, density_thresh: float = 0.01,
                       decay: float = 0.95,
                       cells_per_slice: int = GRID_CELLS // 8,
                       query_chunk: int = 2**17,
                       uni_codes: Optional[torch.Tensor] = None,
                       uniforms: Optional[torch.Tensor] = None,
                       jitter: Optional[torch.Tensor] = None,
                       time_jitter: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> OccupancyStateT:
    """Refresh the time slices `t_indices` (a sequence of ints): per slice
    and cascade, `cells_per_slice` uniform cells plus as many resamples of
    the slice's occupied cells, queried at jittered positions and at times
    jittered within the slice; scatter-max of repeated cells, decay over the
    written (and trained) cells alone; then the threshold min(mean density
    of all slices, density_thresh) and one bitfield per slice.

    density_fn: (x [M, 3], t [M]) -> sigma [M] (density-scaled).
    The random numbers, per refreshed slice i and cascade c, where given
    (tests hand both packages the same): uni_codes [n, C, Q] int cell codes,
    uniforms [n, C, Q] in [0, 1) for the occupied resamples, jitter
    [n, C, 2Q, 3] and time_jitter [n, C, 2Q] in [0, 1); None draws them from
    `generator`.
    """
    grid = state.density_grid.clone()
    time_size, cascades, _ = grid.shape
    dev = grid.device
    q = cells_per_slice

    def rand(given, i, cas, shape):
        return (given[i, cas] if given is not None else
                torch.rand(shape, generator=generator, device=dev))

    for i, ti in enumerate(int(t) for t in t_indices):
        for cas in range(cascades):
            uni = (uni_codes[i, cas].to(torch.int64) if uni_codes is not None
                   else torch.randint(0, GRID_CELLS, (q,), generator=generator,
                                      device=dev))
            occ = _sample_occupied(rand(uniforms, i, cas, (q,)),
                                   grid[ti, cas] > 0.0)
            codes = torch.cat([uni, occ])
            n = codes.shape[0]
            xs = cell_world_positions(codes, cas, bound,
                                      rand(jitter, i, cas, (n, 3)))
            tval = (ti + 0.5) / time_size
            tj = tval + (rand(time_jitter, i, cas, (n,)) - 0.5) / time_size
            vals = torch.cat([density_fn(xs[j:j + query_chunk],
                                         tj[j:j + query_chunk])
                              for j in range(0, n, query_chunk)])
            cur = grid[ti, cas]
            new = torch.zeros_like(cur).scatter_reduce_(0, codes, vals, "amax")
            written = torch.zeros_like(cur, dtype=torch.bool)
            written[codes] = True
            grid[ti, cas] = torch.where(written & (cur >= 0.0),
                                        torch.maximum(cur * decay, new), cur)
    mean_density = grid.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    bitfield = torch.stack([packbits(g, thresh) for g in grid])
    return OccupancyStateT(density_grid=grid, bitfield=bitfield,
                           mean_density=mean_density,
                           iter_density=state.iter_density + 1)
