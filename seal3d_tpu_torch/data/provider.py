"""Dataset provider: instant-ngp / Blender / COLMAP `transforms*.json` scenes.

A numpy-only copy of seal3d_tpu/data/provider.py (the port never imports the
JAX package), with its debug pose plot (`visualize_poses`, matplotlib
imported inside it).

Equivalent of reference NeRFDataset (nerf/provider.py:94-332): pose loading +
`nerf_matrix_to_ngp` conversion, image loading (RGBA kept), downscale,
error-map allocation, preload-to-device; per-step ray batches are generated on
device by the trainer (data/rays.py) instead of inside a DataLoader collate.

Images are read with cv2 where it imports, as the JAX package reads them, and
otherwise by `read_png` (zlib and numpy; the scanline filters are undone by
csrc/png_unfilter.cpp, built with g++ at first use) with `area_downscale` in
place of cv2.INTER_AREA. Both give the same pixels. A frame whose image
cannot be read raises `ImageReadError`.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

try:  # optional, as in the JAX package; read_png serves where it is missing
    import cv2
except ImportError:
    cv2 = None

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> channels (gray, RGB, RGBA)


class ImageReadError(ValueError):
    """An image of a scene that cannot be read: missing, not a PNG this
    reader decodes (8-bit gray, RGB or RGBA, not interlaced), or corrupt."""


def png_scanlines(path: str):
    """An 8-bit gray, RGB or RGBA, non-interlaced PNG -> (its inflated
    scanlines, each a filter-type byte and then the row's filtered bytes;
    H, W, channels). Any other PNG, or a damaged one, raises
    ImageReadError."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise ImageReadError(f"{path}: {e}") from e
    if not blob.startswith(_PNG_SIGNATURE):
        raise ImageReadError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while True:
        if pos + 8 > len(blob):
            raise ImageReadError(f"{path}: truncated before IEND")
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        crc = blob[pos + 8 + length:pos + 12 + length]
        if len(data) != length or len(crc) != 4:
            raise ImageReadError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + data):
            raise ImageReadError(f"{path}: bad CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind in (b"PLTE", b"tRNS"):
            raise ImageReadError(f"{path}: palette or transparency chunks "
                                 "are not read")
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ImageReadError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, method, filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace or method \
            or filt:
        raise ImageReadError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}: only 8-bit gray, RGB and RGBA non-interlaced PNGs "
            "are read")
    c = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageReadError(f"{path}: {e}") from e
    if len(raw) != h * (w * c + 1):
        raise ImageReadError(f"{path}: {len(raw)} bytes of scanlines, "
                             f"expected {h * (w * c + 1)}")
    return raw, h, w, c


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA, non-interlaced PNG -> uint8 [H, W] (gray)
    or [H, W, C] in RGB(A) order: the pixels cv2.imread(path,
    IMREAD_UNCHANGED) gives, with its BGR(A) order reversed. Any other PNG,
    or a damaged one, raises ImageReadError."""
    raw, h, w, c = png_scanlines(path)
    row = w * c
    from seal3d_tpu_torch.runtime.build import load_host_library

    fn = load_host_library("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int64
    out = np.empty((h, w, c), np.uint8)
    bad = fn(raw, out.ctypes.data, h, row, c)
    if bad >= 0:
        raise ImageReadError(f"{path}: row {bad} has filter type "
                             f"{raw[bad * (row + 1)]}")
    return out[..., 0] if c == 1 else out


def area_downscale(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 [H, W(, C)] -> [h, w(, C)] by the mean of each factor x factor
    block, rounded to nearest: cv2.resize's INTER_AREA for an integer factor
    (H = h * factor, W = w * factor); other sizes raise ImageReadError."""
    fy, fx = img.shape[0] // h, img.shape[1] // w
    if fy != fx or img.shape[0] != h * fy or img.shape[1] != w * fx:
        raise ImageReadError(f"a {img.shape[1]}x{img.shape[0]} image does not"
                             f" shrink to {w}x{h} by an integer factor")
    blocks = img.reshape(h, fy, w, fx, -1).astype(np.uint32).sum((1, 3))
    out = ((blocks + fy * fx // 2) // (fy * fx)).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def read_image(path: str) -> np.ndarray:
    """One frame's image, uint8, in RGB(A) order: through cv2 where it
    imports (as the JAX package), else read_png. Raises ImageReadError."""
    if cv2 is None:
        return read_png(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ImageReadError(f"{path}: cv2 cannot read it")
    if img.ndim == 3 and img.shape[-1] >= 3:
        # BGR(A) -> RGB(A)
        img = img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]
    return img


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


def ngp_to_nerf_matrix(pose: np.ndarray, scale: float = 0.33,
                       offset=(0, 0, 0)) -> np.ndarray:
    """The inverse of nerf_matrix_to_ngp: an ngp-convention c2w matrix back
    to the NeRF/Blender one a `transforms_*.json` stores (what
    scripts/make_blender_fixture.py writes)."""
    flip = np.array([1, -1, -1], np.float32)
    out = np.eye(4, dtype=np.float32)
    for src, dst in ((0, 1), (1, 2), (2, 0)):
        out[dst, :3] = pose[src, :3] * flip
        out[dst, 3] = (pose[src, 3] - offset[src]) / scale
    return out


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


def visualize_poses(poses, size: float = 0.1, out_path: str = "poses.png"):
    """Debug plot of camera frames (the reference's visualize_poses): each
    pose's x, y, z axes as red, green and blue arrows of length `size` from
    its origin, a matplotlib 3-D quiver saved to `out_path` (returned)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    for pose in np.asarray(poses):
        o = pose[:3, 3]
        for axis, color in zip(range(3), "rgb"):
            d = pose[:3, axis] * size
            ax.quiver(o[0], o[1], o[2], d[0], d[1], d[2], color=color)
    ax.set_box_aspect([1, 1, 1])
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


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
            img = read_image(img_path)
            if h == 0:
                h, w = img.shape[0] // downscale, img.shape[1] // downscale
            if downscale > 1:
                img = (area_downscale(img, h, w) if cv2 is None else
                       cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))
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

        if not images:
            raise ValueError(f"{root_path}: no frames in split {split!r}")
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
