"""Image quality metrics (port of seal3d_tpu/train/metrics.py), numpy only.

PSNR and its meter, SSIM with a uniform window, `lpips_proxy`, the
reference's weight-free perceptual distance, and `LPIPSMeter`, LPIPS
(AlexNet) gated on a local weights file: `lpips` is imported only when a
path is given, and nothing is downloaded. `PerceptualMeter(weights_path)`
runs LPIPS where that meter is available, else the proxy, and says which in
`kind`.
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


class LPIPSMeter:
    """Mean LPIPS (AlexNet) over the images it was given, available only
    where `weights_path` names a local checkpoint that the `lpips` package
    loads; else `available` is False and it measures None."""

    def __init__(self, weights_path=None):
        self.available = False
        self.v, self.n = 0.0, 0
        if weights_path:
            try:
                import lpips

                self.fn = lpips.LPIPS(net="alex", model_path=weights_path)
                self.available = True
            except (ImportError, OSError, RuntimeError):
                # no lpips, no such file, or weights it cannot load
                self.available = False

    def update(self, pred, truth):
        if not self.available:
            return
        import torch

        p = torch.from_numpy(np.asarray(pred)).permute(2, 0, 1)[None] * 2 - 1
        t = torch.from_numpy(np.asarray(truth)).permute(2, 0, 1)[None] * 2 - 1
        with torch.no_grad():
            self.v += float(self.fn(p, t).item())
        self.n += 1

    def measure(self):
        return self.v / max(self.n, 1) if self.available else None


class PerceptualMeter:
    """LPIPS where `LPIPSMeter(weights_path)` is available, else the mean
    `lpips_proxy`; `kind` says which one ran."""

    def __init__(self, weights_path=None):
        self._lpips = LPIPSMeter(weights_path)
        self.kind = "lpips" if self._lpips.available else "lpips_proxy"
        self.v, self.n = 0.0, 0

    def update(self, pred, truth):
        if self._lpips.available:
            self._lpips.update(pred, truth)
        else:
            self.v += lpips_proxy(pred, truth)
            self.n += 1

    def measure(self) -> float:
        if self._lpips.available:
            return self._lpips.measure()
        return self.v / max(self.n, 1)

    def report(self) -> str:
        return f"{self.kind} = {self.measure():.4f}"
