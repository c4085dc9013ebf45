"""Sample positions that stress the hash-encode kernels' tiles and runs, made
with numpy from a seed (no torch, no JAX): the CPU parity tests and the
`cuda` tests of the hash encode feed the same inputs.

Every function takes `level_params` (HashGridConfig.level_params: resolution,
offset, size, use_hash, scale per level) and returns x [M, 3] float32 in
[0, 1], in the order a ray march hands samples over.
"""

import numpy as np

_PRIMES = (1, 2654435761, 805459861)


def one_coarse_cell(level_params, m=4133, seed=0):
    """A ray segment inside one cell of level 0: every warp of 32 consecutive
    samples is one run on the coarse levels, and runs of shrinking length up
    the levels."""
    _, _, _, _, scale = level_params[0]
    rng = np.random.default_rng(seed)
    start = (np.array([5.2, 7.3, 3.1]) - 0.5) / scale     # inside cell (5,7,3)
    end = (np.array([5.8, 7.6, 3.9]) - 0.5) / scale
    t = np.sort(rng.uniform(0, 1, m))[:, None]
    return (start + t * (end - start)).astype(np.float32)


def warp_edge_runs(level_params, groups=40, run=24, seed=1):
    """Runs of `run` consecutive samples within 1e-6 of one point each: at 24
    a run, every fourth run straddles the edge between two warps, on every
    level."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.1, 0.9, (groups, 1, 3))
    x = centres + rng.uniform(-1e-6, 1e-6, (groups, run, 3))
    return x.reshape(-1, 3).astype(np.float32)


def _rows(cells, resolution, size):
    """Hashed table rows [N, 8] of the 8 corners of integer cells [N, 3]."""
    off = np.array([[(c >> d) & 1 for d in range(3)] for c in range(8)])
    corner = np.minimum(cells[:, None, :] + off[None], resolution - 1)
    corner = corner.astype(np.uint64)
    h = corner[..., 0] * _PRIMES[0]
    for d in (1, 2):
        h = h ^ ((corner[..., d] * _PRIMES[d]) & 0xFFFFFFFF)
    return (h & np.uint64(size - 1)).astype(np.int64)


def colliding_cells(level_params, pairs=12, run=10, seed=2):
    """Samples that alternate, `run` at a time, between two cells of the
    finest level (hashed) whose corners 0 share one table row (a hash
    collision): consecutive lanes then hold an equal row and different
    cells. Returns (x, level, cells [pairs, 2, 3]). (Cells that touch each
    other almost never collide: the hash is an XOR of per-axis products.)"""
    level = len(level_params) - 1
    resolution, _, size, hashed, scale = level_params[level]
    assert hashed, "the finest level is not hashed"
    rng = np.random.default_rng(seed)
    a = rng.integers(1, resolution - 4, (1 << 18, 3))
    b = rng.integers(1, resolution - 4, a.shape)
    # the x coordinate that gives b's corner 0 the row of a's corner 0
    rest = _rows(np.concatenate([np.zeros_like(b[:, :1]), b[:, 1:]], 1),
                 resolution, size)[:, 0]
    b[:, 0] = _rows(a, resolution, size)[:, 0] ^ rest
    ok = np.flatnonzero((b[:, 0] >= 1) & (b[:, 0] < resolution - 4)
                        & (a != b).any(1))[:pairs]
    assert len(ok) == pairs, f"only {len(ok)} colliding pairs found"
    cells = np.stack([a[ok], b[ok]], 1)
    rows = _rows(cells.reshape(-1, 3), resolution, size)[:, 0].reshape(-1, 2)
    assert (rows[:, 0] == rows[:, 1]).all()
    xs = []
    for pair in cells:
        for cell in (pair[0], pair[1], pair[0], pair[1]):
            pos = cell + rng.uniform(0.1, 0.9, (run, 3))   # x*scale + 0.5
            xs.append((pos - 0.5) / scale)
    return np.concatenate(xs).astype(np.float32), level, cells


CASES = {"one_coarse_cell": one_coarse_cell, "warp_edge_runs": warp_edge_runs,
         "colliding_cells": lambda lp: colliding_cells(lp)[0]}
