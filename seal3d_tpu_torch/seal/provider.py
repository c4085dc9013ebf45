"""Seal datasets (port of seal3d_tpu/seal/provider.py): `proxy_dataset`
replaces every ground-truth image and depth with a teacher render once up
front; `seal_random_dataset` makes orbit poses around the mapper's
pose_center / pose_radius."""

from __future__ import annotations

import numpy as np
import torch

from seal3d_tpu_torch.data.provider import NeRFDataset, rand_poses
from seal3d_tpu_torch.seal.mappers import SealMapper


def seal_random_dataset(mapper: SealMapper, n_views: int, h: int, w: int,
                        intrinsics: np.ndarray, seed: int = 0,
                        radius_scale: float = 0.1) -> NeRFDataset:
    """Poses orbiting the edit region (images filled by proxy_dataset)."""
    rng = np.random.default_rng(seed)
    radius = max(mapper.pose_radius * radius_scale, 0.3)
    poses = rand_poses(rng, n_views, radius=radius, theta_range=(45, 105),
                       look_at=mapper.pose_center)
    return NeRFDataset(poses=poses, images=None,
                       intrinsics=np.asarray(intrinsics, np.float32),
                       h=h, w=w, radius=radius)


def proxy_dataset(dataset: NeRFDataset, render_view_fn) -> NeRFDataset:
    """A new dataset whose images (uint8 RGB) and depths (f32) are teacher
    renders. render_view_fn: pose -> (image [H, W, 3] in [0, 1], depth
    [H, W]) tensors. Every view is rendered first and the stack fetched
    with one device -> host copy."""
    images, depths = zip(*(render_view_fn(pose) for pose in dataset.poses))
    images = (torch.stack(images).clamp(0, 1) * 255).to(torch.uint8)
    return NeRFDataset(
        poses=dataset.poses, images=images.cpu().numpy(),
        intrinsics=dataset.intrinsics, h=dataset.h, w=dataset.w,
        radius=dataset.radius, error_map=dataset.error_map,
        depths=torch.stack(depths).to(torch.float32).cpu().numpy())
