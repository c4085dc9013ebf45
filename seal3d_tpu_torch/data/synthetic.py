"""Procedural analytic scene + ground-truth renderer (port of the
`SyntheticScene` of seal3d_tpu/data/synthetic.py): colored blobs, a box and
a torus inside [-bound, bound]^3, rendered with the dense compositor;
`WideSyntheticScene`, its bound-2 variant with content outside [-1, 1]^3;
`DynamicSyntheticScene`, a ball swinging on an arc over a box as time
runs over [0, 1] (D-NeRF's scene); and `HardSyntheticScene`, thin structures
and a high-frequency texture for table-capacity comparisons.
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
                    device=None, bg: float = 1.0):
        pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
        intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
        rays = get_full_rays(pose, intr, h, w)
        imgs, deps = [], []
        for i in range(0, h * w, chunk):
            img, dep = self.render_rays(rays["rays_o"][i:i + chunk],
                                        rays["rays_d"][i:i + chunk], bg=bg)
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
class HardSyntheticScene(SyntheticScene):
    """Lego-like frequency content with no smooth shortcut: a studded base
    plate (a 7x7 grid of sphere caps), four thin pillars under a top frame
    (struts 4.4 cm wide), a thin-shell wheel and a 3-D checker and stripe
    texture at ~15 cycles a unit. Small hash tables underfit it visibly."""

    density_scale: float = 90.0
    gt_steps: int = 768  # thin structures need a finer ground-truth ladder

    def density(self, x: torch.Tensor) -> torch.Tensor:
        k = 220.0  # much sharper edges than the base scene

        def sd_box(c, half):
            q = (x - _const(x, c)).abs() - _const(x, half)
            return (torch.linalg.norm(q.clamp(min=0.0), dim=-1)
                    + q.amax(-1).clamp(max=0.0))

        def occ(d):
            return torch.sigmoid(-k * d)

        total = occ(sd_box([0.0, -0.42, 0.0], [0.5, 0.03, 0.5]))  # plate
        pitch = 0.125    # studs: fold x and z into the nearest grid cell
        gx = torch.clamp(torch.round(x[..., 0] / pitch), -3, 3) * pitch
        gz = torch.clamp(torch.round(x[..., 2] / pitch), -3, 3) * pitch
        stud = torch.stack([x[..., 0] - gx, x[..., 1] + 0.37,
                            x[..., 2] - gz], -1)
        total = total + occ(torch.linalg.norm(stud, dim=-1) - 0.040)
        for sx in (-0.38, 0.38):     # pillars
            for sz in (-0.38, 0.38):
                total = total + occ(sd_box([sx, -0.05, sz],
                                           [0.022, 0.34, 0.022]))
        for sx in (-0.38, 0.38):     # top frame
            total = total + occ(sd_box([sx, 0.29, 0.0], [0.022, 0.022, 0.4]))
            total = total + occ(sd_box([0.0, 0.29, sx], [0.4, 0.022, 0.022]))
        # the wheel: a torus tilted 45 degrees about x
        pr = torch.stack([x[..., 0],
                          (x[..., 1] + x[..., 2]) * 0.70710678,
                          (x[..., 2] - x[..., 1]) * 0.70710678], -1)
        q = torch.stack([torch.sqrt(pr[..., 0] ** 2 + pr[..., 2] ** 2) - 0.26,
                         pr[..., 1]], -1)
        total = total + occ(torch.linalg.norm(q, dim=-1) - 0.028)
        return self.density_scale * total.clamp(0.0, 1.0)

    def color(self, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """A 3-D checker and stripes over a position-keyed palette, with
        the base scene's view sheen."""
        checker = (torch.sin(47.0 * x[..., 0]) * torch.sin(43.0 * x[..., 1])
                   * torch.sin(53.0 * x[..., 2]))
        stripes = torch.sin(89.0 * (x[..., 0] + x[..., 2]))
        base = torch.stack([0.5 + 0.28 * torch.tanh(6.0 * checker),
                            0.5 + 0.28 * torch.tanh(6.0 * stripes),
                            0.5 + 0.4 * torch.sin(3.0 * x[..., 1] + 2.0)],
                           dim=-1)
        sheen = 0.1 * (0.5 + 0.5 * d[..., 1])
        return (base + sheen[..., None]).clamp(0.0, 1.0)

    def render_rays(self, rays_o, rays_d, num_steps=None, bg: float = 1.0):
        return SyntheticScene.render_rays(
            self, rays_o, rays_d, num_steps=num_steps or self.gt_steps, bg=bg)


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


@dataclass(frozen=True)
class DynamicSyntheticScene(SyntheticScene):
    """Time-varying variant: a ball swings on a +-0.9 rad arc of radius
    `orbit_radius` over the box of SyntheticScene (bounded motion, as in the
    reference's D-NeRF scenes); colours are SyntheticScene's."""

    orbit_radius: float = 0.4

    def density_t(self, x: torch.Tensor, t) -> torch.Tensor:
        """[..., 3] positions at time t (a scalar or [...]) -> [...] sigma."""
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        ang = 0.9 * torch.sin(2.0 * torch.pi * t)
        c = torch.stack([self.orbit_radius * torch.cos(ang),
                         torch.zeros_like(ang) + 0.1,
                         self.orbit_radius * torch.sin(ang)], -1)
        d = torch.linalg.norm(x - c, dim=-1) - 0.22
        moving = torch.sigmoid(-EDGE_K * d)
        static = _box(x, [0.0, -0.35, 0.0], [0.45, 0.08, 0.45])
        return self.density_scale * (moving + static).clamp(0.0, 1.0)

    def render_rays_t(self, rays_o, rays_d, t, num_steps: int = 256,
                      bg: float = 1.0):
        n = rays_o.shape[0]
        near, far = 0.05, 2.0 * self.bound + 2.0
        lin = torch.linspace(0.0, 1.0, num_steps, device=rays_o.device)
        z = (near + (far - near) * lin)[None, :].expand(n, num_steps)
        xyz = rays_o[:, None] + z[..., None] * rays_d[:, None]
        inside = (xyz.abs() <= self.bound).all(-1)
        sigma = torch.where(inside, self.density_t(xyz, t), 0.0)
        rgb = self.color(xyz, rays_d[:, None].expand(xyz.shape))
        deltas = torch.diff(z, dim=-1)
        deltas = torch.cat([deltas, deltas[..., -1:]], -1)
        out = composite_dense(sigma, rgb, deltas, z)
        image = out["image"] + (1.0 - out["weights_sum"])[:, None] * bg
        return image, out["depth"]

    def make_dataset(self, n_views: int = 24, h: int = 128, w: int = 128,
                     radius: float = 2.2, seed: int = 0, fov_deg: float = 50.0,
                     views_per_time: int = 2, device=None) -> NeRFDataset:
        """Random orbit views in groups of `views_per_time` that share one
        time; the times run evenly over [0, 1] (a remainder of views gets
        time 1)."""
        rng = np.random.default_rng(seed)
        poses = rand_poses(rng, n_views, radius=radius, theta_range=(30, 120))
        fx = fy = 0.5 * w / np.tan(0.5 * np.deg2rad(fov_deg))
        intr = np.array([fx, fy, w / 2.0, h / 2.0], np.float32)
        vpt = max(views_per_time, 1)
        n_times = max(n_views // vpt, 1)
        times = np.repeat(np.linspace(0.0, 1.0, n_times), vpt)[:n_views]
        if len(times) < n_views:
            times = np.concatenate([times, np.ones(n_views - len(times))])
        times = times.astype(np.float32)
        images = []
        with torch.no_grad():
            for p, t in zip(poses, times):
                pose = torch.as_tensor(p, dtype=torch.float32, device=device)
                rays = get_full_rays(pose, torch.as_tensor(intr, device=device),
                                     h, w)
                img = torch.cat([
                    self.render_rays_t(rays["rays_o"][i:i + 16384],
                                       rays["rays_d"][i:i + 16384],
                                       float(t))[0]
                    for i in range(0, h * w, 16384)]).reshape(h, w, 3)
                images.append((img.clamp(0, 1) * 255).to(torch.uint8)
                              .cpu().numpy())
        return NeRFDataset(poses=poses.astype(np.float32),
                           images=np.stack(images), intrinsics=intr, h=h, w=w,
                           radius=radius, times=times)
