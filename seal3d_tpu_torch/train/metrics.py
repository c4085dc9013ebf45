"""Image quality metrics (port of seal3d_tpu/train/metrics.py), numpy only.

PSNR and its meter, SSIM with a uniform window, and `lpips_proxy`, the
reference's weight-free perceptual distance. The reference's LPIPS meter
needs the `lpips` package and local AlexNet weights; the port's
`PerceptualMeter` always runs the proxy and says so in `kind`.
"""

from __future__ import annotations

import numpy as np


def psnr(pred, truth) -> float:
    mse = float(np.mean((np.asarray(pred) - np.asarray(truth)) ** 2))
    if mse <= 1e-12:
        return 99.0
    return -10.0 * np.log10(mse)


class PSNRMeter:
    """Mean PSNR over the images it was given."""

    def __init__(self):
        self.v, self.n = 0.0, 0

    def update(self, pred, truth):
        self.v += psnr(pred, truth)
        self.n += 1

    def measure(self) -> float:
        return self.v / max(self.n, 1)


def _box(x: np.ndarray, k: int) -> np.ndarray:
    """Mean over every k x k window (valid positions), by summed areas."""
    c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
    return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)


def ssim(pred, truth, window: int = 7, c1: float = 0.01**2,
         c2: float = 0.03**2) -> float:
    """Mean SSIM with a uniform window, grayscale-averaged channels."""
    p = np.asarray(pred, np.float32)
    t = np.asarray(truth, np.float32)
    if p.ndim == 3:
        p, t = p.mean(-1), t.mean(-1)
    mp, mt = _box(p, window), _box(t, window)
    vp = _box(p * p, window) - mp * mp
    vt = _box(t * t, window) - mt * mt
    cov = _box(p * t, window) - mp * mt
    s = (((2 * mp * mt + c1) * (2 * cov + c2))
         / ((mp * mp + mt * mt + c1) * (vp + vt + c2)))
    return float(s.mean())


def lpips_proxy(pred, truth, scales: int = 4) -> float:
    """Weight-free multi-scale distance of contrast-normalised image
    gradients; 0 = identical. Rank-correlated with LPIPS, not comparable to
    it (see the reference's docstring)."""
    p = np.asarray(pred, np.float32)
    t = np.asarray(truth, np.float32)
    if p.ndim == 3:
        p, t = p.mean(-1), t.mean(-1)

    def feats(x):
        gx = np.diff(x, axis=0)[:, :-1]
        gy = np.diff(x, axis=1)[:-1, :]
        mag = np.sqrt(gx * gx + gy * gy)
        k = 5  # local contrast normalisation over a 5x5 box of |grad|
        local = _box(np.pad(mag, ((0, k - 1), (0, k - 1)), mode="edge"), k)
        n = local[: gx.shape[0], : gx.shape[1]] + 0.01
        return gx / n, gy / n

    def down(x):
        if x.shape[0] % 2 == 0 and x.shape[1] % 2 == 0:
            return 0.25 * (x[::2, ::2] + x[1::2, ::2] + x[::2, 1::2]
                           + x[1::2, 1::2])
        return x[::2, ::2]

    total = 0.0
    for _ in range(scales):
        if min(p.shape) < 8:
            break
        pgx, pgy = feats(p)
        tgx, tgy = feats(t)
        total += float(np.mean((pgx - tgx) ** 2 + (pgy - tgy) ** 2)) / scales
        p, t = down(p), down(t)
    return total


class PerceptualMeter:
    """Mean `lpips_proxy` over the images it was given."""

    kind = "lpips_proxy"

    def __init__(self):
        self.v, self.n = 0.0, 0

    def update(self, pred, truth):
        self.v += lpips_proxy(pred, truth)
        self.n += 1

    def measure(self) -> float:
        return self.v / max(self.n, 1)
