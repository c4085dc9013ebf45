"""Ray generation (port of seal3d_tpu/data/rays.py): the train-batch
pixel samplers (uniform in `get_rays`, error-map weighted in
`error_map_inds`, aligned patches in `patch_inds`) and full-image rays for
renders. Each sampler draws from an explicit generator, or takes its random
numbers as inputs (the reference draws them from JAX keys).

Pose convention: camera-to-world, +z forward (data/provider.py).
"""

from __future__ import annotations

from typing import Optional

import torch


def rays_from_pixels(pose: torch.Tensor, intrinsics: torch.Tensor,
                     i: torch.Tensor, j: torch.Tensor):
    """pose [4, 4]; pixel coords i (column), j (row) [...] ->
    (rays_o, rays_d) [..., 3] with unit directions."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    xs = (i.to(torch.float32) + 0.5 - cx) / fx
    ys = (j.to(torch.float32) + 0.5 - cy) / fy
    dirs = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    rays_d = torch.einsum("ij,...j->...i", pose[:3, :3], dirs)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return pose[:3, 3].expand(rays_d.shape), rays_d


def get_full_rays(pose: torch.Tensor, intrinsics: torch.Tensor, h: int, w: int):
    """All h*w rays of one view, row-major: dict(rays_o, rays_d) [h*w, 3]."""
    row, col = torch.meshgrid(torch.arange(h, device=pose.device),
                              torch.arange(w, device=pose.device),
                              indexing="ij")
    rays_o, rays_d = rays_from_pixels(pose, intrinsics, col, row)
    return {"rays_o": rays_o.reshape(-1, 3), "rays_d": rays_d.reshape(-1, 3)}


def get_rays(pose: torch.Tensor, intrinsics: torch.Tensor, h: int, w: int,
             num_rays: int, generator: Optional[torch.Generator] = None,
             inds: Optional[torch.Tensor] = None):
    """`num_rays` uniformly drawn pixels of one view (drawn from `generator`
    on the pose's device, or given as flat indices `inds` [num_rays]) ->
    dict(rays_o, rays_d [N, 3], inds [N] flat pixel indices)."""
    if inds is None:
        inds = torch.randint(0, h * w, (num_rays,), generator=generator,
                             device=pose.device)
    rays_o, rays_d = rays_from_pixels(pose, intrinsics, inds % w, inds // w)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}


ERROR_MAP_RES = 128   # the reference's error map: 128 x 128 cells a view


def error_map_inds(error_map: torch.Tensor, h: int, w: int, num_rays: int,
                   generator: Optional[torch.Generator] = None,
                   cells: Optional[torch.Tensor] = None,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat pixel indices [num_rays] drawn from one view's error map
    [128*128]: a cell with probability proportional to error + 1e-8 (the
    reference's `jax.random.categorical` over its log), then a uniform
    offset inside the cell, the pixel clipped to the image. `cells`
    [num_rays] and `u` [num_rays, 2], where given, replace the draws."""
    e = ERROR_MAP_RES
    if cells is None:
        cells = torch.multinomial(error_map + 1e-8, num_rays,
                                  replacement=True, generator=generator)
    if u is None:
        u = torch.rand((num_rays, 2), generator=generator,
                       device=error_map.device)
    ci, cj = cells // e, cells % e
    row = ((ci + u[:, 0]) * (h / e)).to(torch.int32).clamp(0, h - 1)
    col = ((cj + u[:, 1]) * (w / e)).to(torch.int32).clamp(0, w - 1)
    return row.to(torch.int64) * w + col


def patch_inds(h: int, w: int, num_rays: int, patch_size: int,
               generator: Optional[torch.Generator] = None,
               corners: Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
    """Flat pixel indices of num_rays // patch_size^2 aligned square
    patches, patch after patch in row-major order. corners [P, 2] (top
    row, left column) replace the uniform draws in [0, h - patch_size) x
    [0, w - patch_size)."""
    n = num_rays // (patch_size * patch_size)
    if corners is None:
        corners = torch.stack([
            torch.randint(0, h - patch_size, (n,), generator=generator,
                          device=device),
            torch.randint(0, w - patch_size, (n,), generator=generator,
                          device=device)], -1)
    d = torch.arange(patch_size, device=corners.device)
    row = corners[:, 0, None, None] + d[None, :, None]
    col = corners[:, 1, None, None] + d[None, None, :]
    return (row * w + col).reshape(-1).to(torch.int64)


def error_map_cells(inds: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The error-map cell [N] of each flat pixel index (the reference's
    refresh of the sampled cells)."""
    e = ERROR_MAP_RES
    return (inds // w * e // h) * e + (inds % w * e // w)
