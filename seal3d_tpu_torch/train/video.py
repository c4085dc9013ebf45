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


def _filter_scanlines(px: np.ndarray, bpp: int) -> np.ndarray:
    """[H, row] uint8 pixels -> [H, 1 + row] PNG scanlines, each row under
    the filter (None, Sub, Up, Average or Paeth) whose bytes, read as signed,
    have the least absolute sum: the PNG specification's heuristic."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cands = (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
             & 0xFF).astype(np.uint8)                          # [5, H, row]
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)
    choice = cost.argmin(0)
    rows = cands[choice, np.arange(px.shape[0])]
    return np.concatenate([choice.astype(np.uint8)[:, None], rows], axis=1)


def write_png(path: str, img: np.ndarray):
    """[H, W] gray, or [H, W, C] RGB (C=3) or RGBA (C=4), uint8 -> an 8-bit
    PNG file (adaptive scanline filters, zlib level 6)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = _filter_scanlines(img.reshape(h, w * c), c).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                             0))
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
