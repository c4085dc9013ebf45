"""Test-split output writer: per-view PNGs + rgb/depth mp4 videos.

A copy of seal3d_tpu/train/video.py (numpy-only). PNGs are written by a
small zlib encoder, so rendering does not need imageio; the mp4s use imageio
or cv2 where one is installed, as in the reference writer.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Optional, Tuple

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255).astype(np.uint8)


def _depth_u8(depth: np.ndarray) -> np.ndarray:
    """Normalize a depth map to an 8-bit grayscale frame (reference divides by
    the running max before writing, nerf/utils.py:705)."""
    d = np.asarray(depth, np.float32)
    dmax = float(d.max())
    if dmax > 0:
        d = d / dmax
    return (np.clip(d, 0.0, 1.0) * 255).astype(np.uint8)


def write_test_outputs(
    render_view: Callable[[int], Tuple[np.ndarray, Optional[np.ndarray]]],
    n_views: int,
    out_dir: str,
    name: str,
    fps: int = 24,
    max_png: int = 8,
) -> dict:
    """Render every test view and write PNGs + mp4 videos.

    Args:
      render_view: view index -> (rgb [H,W,3] float in [0,1],
        depth [H,W] float or None).
      n_views: number of views to render.
      out_dir: results directory (created).
      name: file prefix -> {name}_rgb.mp4 / {name}_depth.mp4 /
        {name}_{i:04d}_rgb.png.
      max_png: also dump the first `max_png` frames as PNGs.

    Returns:
      dict with written file paths ('video', 'depth_video', 'pngs').
    """
    os.makedirs(out_dir, exist_ok=True)
    frames, dframes, pngs = [], [], []
    for vi in range(n_views):
        img, depth = render_view(vi)
        frames.append(_to_u8(img))
        if depth is not None:
            dframes.append(np.asarray(depth, np.float32))
        if vi < max_png:
            p = os.path.join(out_dir, f"{name}_{vi:04d}_rgb.png")
            write_png(p, frames[-1])
            pngs.append(p)

    written = {"pngs": pngs, "video": None, "depth_video": None}
    if not frames:
        return written
    written["video"] = _write_mp4(os.path.join(out_dir, f"{name}_rgb.mp4"),
                                  frames, fps)
    if dframes:
        # One global max keeps brightness consistent across the video.
        gmax = max(float(d.max()) for d in dframes) or 1.0
        du8 = [np.repeat((np.clip(d / gmax, 0, 1) * 255)
                         .astype(np.uint8)[..., None], 3, axis=-1)
               for d in dframes]
        written["depth_video"] = _write_mp4(
            os.path.join(out_dir, f"{name}_depth.mp4"), du8, fps)
    return written


def write_png(path: str, rgb: np.ndarray):
    """[H, W, 3] uint8 -> an 8-bit RGB PNG file."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                         axis=1).tobytes()  # filter byte 0 on every row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _write_mp4(path: str, frames, fps: int) -> Optional[str]:
    """imageio(ffmpeg) if present, else cv2 mp4v (what this image ships)."""
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps, macro_block_size=1)
        return path
    except Exception:
        pass
    try:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError("cv2 VideoWriter failed to open")
        for f in frames:
            vw.write(f[:, :, ::-1])  # RGB -> BGR
        vw.release()
        return path
    except Exception as e:
        print(f"[video] mp4 write failed ({e}); PNGs kept")
        return None
