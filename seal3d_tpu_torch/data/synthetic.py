"""Procedural analytic scene + ground-truth renderer (port of the
`SyntheticScene` of seal3d_tpu/data/synthetic.py): colored blobs, a box and
a torus inside [-bound, bound]^3, rendered with the dense compositor; and
`WideSyntheticScene`, its bound-2 variant with content outside [-1, 1]^3.
The hard and dynamic variants are not on the ported path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from seal3d_tpu_torch.data.provider import NeRFDataset, rand_poses
from seal3d_tpu_torch.data.rays import get_full_rays
from seal3d_tpu_torch.ops.composite import composite_dense

EDGE_K = 60.0  # edge sharpness of the smooth indicators


def _const(x: torch.Tensor, v) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def _ball(x, c, r):
    d = torch.linalg.norm(x - _const(x, c), dim=-1) - r
    return torch.sigmoid(-EDGE_K * d)


def _box(x, c, half):
    q = (x - _const(x, c)).abs() - _const(x, half)
    d = (torch.linalg.norm(q.clamp(min=0.0), dim=-1)
         + q.amax(-1).clamp(max=0.0))
    return torch.sigmoid(-EDGE_K * d)


def _torus(x, c, big_r, r):
    p = x - _const(x, c)
    q = torch.stack([torch.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - big_r,
                     p[..., 1]], -1)
    d = torch.linalg.norm(q, dim=-1) - r
    return torch.sigmoid(-EDGE_K * d)


@dataclass(frozen=True)
class SyntheticScene:
    """A fixed arrangement of soft solids inside [-bound, bound]^3."""

    bound: float = 1.0
    density_scale: float = 60.0

    def density(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 3] -> [...] sigma (smooth indicators)."""
        occ = (_ball(x, [0.35, 0.1, 0.0], 0.22)
               + _ball(x, [-0.3, -0.05, 0.25], 0.18)
               + _box(x, [0.0, -0.35, 0.0], [0.45, 0.08, 0.45])
               + _torus(x, [0.0, 0.25, -0.2], 0.28, 0.09))
        return self.density_scale * occ.clamp(0.0, 1.0)

    def color(self, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """[..., 3], [..., 3] -> [..., 3] albedo with mild view-dependence."""
        base = torch.stack([0.5 + 0.5 * torch.sin(4.0 * x[..., 0]),
                            0.5 + 0.5 * torch.sin(5.0 * x[..., 1] + 1.0),
                            0.5 + 0.5 * torch.cos(4.0 * x[..., 2])], dim=-1)
        sheen = 0.15 * (0.5 + 0.5 * d[..., 1])
        return (base + sheen[..., None]).clamp(0.0, 1.0)

    def render_rays(self, rays_o, rays_d, num_steps: int = 384, bg: float = 1.0):
        n = rays_o.shape[0]
        near, far = 0.05, 2.0 * self.bound + 2.0
        lin = torch.linspace(0.0, 1.0, num_steps, device=rays_o.device)
        z = (near + (far - near) * lin)[None, :].expand(n, num_steps)
        xyz = rays_o[:, None] + z[..., None] * rays_d[:, None]
        inside = (xyz.abs() <= self.bound).all(-1)
        sigma = torch.where(inside, self.density(xyz), 0.0)
        rgb = self.color(xyz, rays_d[:, None].expand(xyz.shape))
        deltas = torch.diff(z, dim=-1)
        deltas = torch.cat([deltas, deltas[..., -1:]], -1)
        out = composite_dense(sigma, rgb, deltas, z)
        image = out["image"] + (1.0 - out["weights_sum"])[:, None] * bg
        return image, out["depth"]

    @torch.no_grad()
    def render_view(self, pose, intrinsics, h: int, w: int, chunk: int = 16384,
                    device=None):
        pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
        intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
        rays = get_full_rays(pose, intr, h, w)
        imgs, deps = [], []
        for i in range(0, h * w, chunk):
            img, dep = self.render_rays(rays["rays_o"][i:i + chunk],
                                        rays["rays_d"][i:i + chunk])
            imgs.append(img)
            deps.append(dep)
        return torch.cat(imgs).reshape(h, w, 3), torch.cat(deps).reshape(h, w)

    def make_dataset(self, n_views: int = 24, h: int = 128, w: int = 128,
                     radius: float = 2.2, seed: int = 0, fov_deg: float = 50.0,
                     device=None) -> NeRFDataset:
        """Random orbit views (numpy-seeded poses, as in the reference) with
        ground-truth images rendered on `device`."""
        rng = np.random.default_rng(seed)
        poses = rand_poses(rng, n_views, radius=radius, theta_range=(30, 120))
        fx = fy = 0.5 * w / np.tan(0.5 * np.deg2rad(fov_deg))
        intr = np.array([fx, fy, w / 2.0, h / 2.0], np.float32)
        images = []
        for p in poses:
            img, _ = self.render_view(p, intr, h, w, device=device)
            images.append((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
        return NeRFDataset(poses=poses.astype(np.float32),
                           images=np.stack(images), intrinsics=intr, h=h, w=w,
                           radius=radius)


@dataclass(frozen=True)
class WideSyntheticScene(SyntheticScene):
    """Unbounded-style scene for multi-cascade (bound 2) runs: a central
    object plus satellites outside [-1, 1]^3, so that cascade 1 carries
    content; cameras orbit wider (radius 4, fov 58 degrees)."""

    bound: float = 2.0

    def density(self, x: torch.Tensor) -> torch.Tensor:
        occ = (_ball(x, [0.0, 0.05, 0.0], 0.3)                  # cascade 0
               + _box(x, [0.0, -0.5, 0.0], [0.6, 0.08, 0.6])   # cascade 0
               + _ball(x, [1.45, 0.1, 0.2], 0.28)              # cascade 1
               + _ball(x, [-1.3, -0.15, -0.9], 0.25)           # cascade 1
               + _box(x, [0.2, 0.1, 1.5], [0.3, 0.25, 0.12]))  # cascade 1
        return self.density_scale * occ.clamp(0.0, 1.0)

    def make_dataset(self, n_views: int = 24, h: int = 128, w: int = 128,
                     radius: float = 4.0, seed: int = 0, fov_deg: float = 58.0,
                     device=None) -> NeRFDataset:
        return SyntheticScene.make_dataset(self, n_views=n_views, h=h, w=w,
                                           radius=radius, seed=seed,
                                           fov_deg=fov_deg, device=device)
