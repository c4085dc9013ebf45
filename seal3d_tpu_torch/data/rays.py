"""Ray generation (port of seal3d_tpu/data/rays.py): the uniform train-batch
sampler `get_rays` and full-image rays for renders. The reference's
error-map and patch samplers are not on the ported path.

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
