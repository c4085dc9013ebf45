"""Dataset provider: instant-ngp / Blender / COLMAP `transforms*.json` scenes.

A numpy-only copy of seal3d_tpu/data/provider.py (the port never imports the
JAX package); the debug pose plot is left out.

Equivalent of reference NeRFDataset (nerf/provider.py:94-332): pose loading +
`nerf_matrix_to_ngp` conversion, image loading (RGBA kept), downscale,
error-map allocation, preload-to-device; per-step ray batches are generated on
device by the trainer (data/rays.py) instead of inside a DataLoader collate.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

try:  # cv2 is present in this image; gate anyway for portability
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """Convert a NeRF/Blender c2w matrix to the ngp convention
    (axis cycle + sign flips + scale/offset; reference nerf/provider.py:19-28).
    Output pose has +z forward."""
    new_pose = np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )
    return new_pose


def rand_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
               theta_range=(0, 100), phi_range=(0, 360),
               look_at: Optional[np.ndarray] = None) -> np.ndarray:
    """Random orbit poses looking at `look_at` (default origin).

    Reference rand_poses (nerf/provider.py:57-92) + the `look_at` extension the
    Seal random dataset needs (the reference calls it with look_at but never
    added the param — a shipped bug, SURVEY.md §5.10; here it exists).
    """
    center = np.zeros(3, np.float32) if look_at is None else np.asarray(look_at, np.float32)
    thetas = np.deg2rad(rng.uniform(*theta_range, size))
    phis = np.deg2rad(rng.uniform(*phi_range, size))
    centers = np.stack(
        [
            radius * np.sin(thetas) * np.sin(phis),
            radius * np.cos(thetas),
            radius * np.sin(thetas) * np.cos(phis),
        ],
        axis=-1,
    ) + center
    poses = []
    for c in centers:
        forward = center - c
        forward = forward / (np.linalg.norm(forward) + 1e-9)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, forward)
        right /= np.linalg.norm(right) + 1e-9
        up2 = np.cross(forward, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([right, up2, forward], axis=-1)
        pose[:3, 3] = c
        poses.append(pose)
    return np.stack(poses)


@dataclass
class NeRFDataset:
    """Loaded scene: poses [B,4,4] f32, images [B,H,W,C] uint8 (C=3|4),
    intrinsics [4], H, W. Optional per-image error maps for importance ray
    sampling (reference nerf/provider.py:240-244)."""

    poses: np.ndarray
    images: Optional[np.ndarray]
    intrinsics: np.ndarray
    h: int
    w: int
    radius: float = 1.0
    error_map: Optional[np.ndarray] = None
    depths: Optional[np.ndarray] = None  # teacher-proxied depth (Seal)
    times: Optional[np.ndarray] = None   # [B] in [0,1] for dynamic scenes (D-NeRF)

    @classmethod
    def load(cls, root_path: str, split: str = "train", downscale: int = 1,
             scale: float = 0.33, offset=(0, 0, 0), use_error_map: bool = False,
             mode: Optional[str] = None):
        """Load an instant-ngp ('transforms.json') or Blender
        ('transforms_{split}.json') scene; `trainval` merges train+val."""
        if mode is None:
            mode = "colmap" if os.path.exists(os.path.join(root_path, "transforms.json")) else "blender"

        if mode == "colmap":
            paths = [os.path.join(root_path, "transforms.json")]
        elif split == "trainval":
            paths = [
                os.path.join(root_path, "transforms_train.json"),
                os.path.join(root_path, "transforms_val.json"),
            ]
        else:
            paths = [os.path.join(root_path, f"transforms_{split}.json")]

        frames = []
        meta = None
        for p in paths:
            with open(p) as f:
                t = json.load(f)
            if meta is None:
                meta = t
            frames.extend(t["frames"])

        if mode == "colmap" and split != "all":
            # reference holdout: every 10th frame is val (nerf/provider.py:162-167)
            if split == "train":
                frames = [f for i, f in enumerate(frames) if i % 10 != 0]
            elif split in ("val", "test"):
                frames = [f for i, f in enumerate(frames) if i % 10 == 0]

        # Intrinsics: either global (blender camera_angle_x) or per-file.
        h = int(meta.get("h", 0)) // downscale
        w = int(meta.get("w", 0)) // downscale

        poses, images, times = [], [], []
        for fr in frames:
            # D-NeRF transforms carry per-frame time (reference dnerf/provider.py)
            times.append(float(fr.get("time", len(times) / max(len(frames) - 1, 1))))
            pose = nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32),
                                      scale=scale, offset=offset)
            img_path = os.path.join(root_path, fr["file_path"])
            if not os.path.splitext(img_path)[1]:
                img_path += ".png"
            img = None
            if cv2 is not None and os.path.exists(img_path):
                img = cv2.imread(img_path, cv2.IMREAD_UNCHANGED)
                if img.ndim == 3 and img.shape[-1] >= 3:
                    # BGR(A) -> RGB(A)
                    img = img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]
                if h == 0:
                    h, w = img.shape[0] // downscale, img.shape[1] // downscale
                if downscale > 1:
                    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
            poses.append(pose)
            images.append(img)

        if h == 0 or w == 0:
            raise ValueError(f"could not determine image size for {root_path}")

        if "fl_x" in meta:
            fx = meta["fl_x"] / downscale
            fy = meta.get("fl_y", meta["fl_x"]) / downscale
        elif "camera_angle_x" in meta:
            fx = fy = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        else:
            raise ValueError("transforms.json lacks focal length info")
        cx = meta.get("cx", w / 2.0) / downscale if "cx" in meta else w / 2.0
        cy = meta.get("cy", h / 2.0) / downscale if "cy" in meta else h / 2.0

        imgs = None
        if all(im is not None for im in images) and images:
            imgs = np.stack(images).astype(np.uint8)

        poses = np.stack(poses)
        radius = float(np.linalg.norm(poses[:, :3, 3], axis=-1).mean())
        error_map = None
        if use_error_map:
            error_map = np.full((len(frames), 128 * 128), 0.1, np.float32)
        return cls(poses=poses, images=imgs,
                   intrinsics=np.array([fx, fy, cx, cy], np.float32),
                   h=h, w=w, radius=radius, error_map=error_map,
                   times=np.asarray(times, np.float32) if any(
                       "time" in fr for fr in frames) else None)

    def __len__(self):
        return self.poses.shape[0]
