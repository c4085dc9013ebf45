"""Training losses (port of seal3d_tpu/utils/losses.py)."""

from __future__ import annotations

import torch


def mape_loss(pred: torch.Tensor, target: torch.Tensor, reduce: bool = True):
    """Mean absolute percentage error, per leading row. |pred - target| is
    written where(d >= 0, d, -d): its gradient at a zero difference is +1,
    as jnp.abs's (torch.abs gives 0 there)."""
    difference = (pred - target).reshape(pred.shape[0], -1)
    scale = 1.0 / (target.reshape(pred.shape[0], -1).abs() + 1e-2)
    loss = torch.where(difference >= 0, difference, -difference) * scale
    return loss.mean() if reduce else loss


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1,
               reduce: bool = True):
    """Huber loss with threshold `delta`, per leading row."""
    diff = (pred - target).abs().reshape(pred.shape[0], -1)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return loss.mean() if reduce else loss


def eff_distloss(weights: torch.Tensor, ts: torch.Tensor,
                 deltas: torch.Tensor) -> torch.Tensor:
    """O(K) distortion loss over per-ray sample grids [N, K], averaged over
    rays."""
    wm = weights * ts
    w_cum = torch.cumsum(weights, -1) - weights
    wm_cum = torch.cumsum(wm, -1) - wm
    loss_uni = (weights * weights * deltas).sum(-1) / 3.0
    loss_bi = 2.0 * (wm * w_cum - weights * wm_cum).sum(-1)
    return (loss_uni + loss_bi).mean()
