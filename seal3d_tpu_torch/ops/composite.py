"""Volume-rendering compositing (port of seal3d_tpu/ops/composite.py).

`composite_dense` serves the synthetic scene's ground-truth renderer;
`composite_flat` composites the flat, ray-contiguous sample buffer of the
march (see ops/raymarch.MarchedRays).

Optical depth: the reference carries a TwoSum-compensated float32 prefix
scan, because a plain float32 cumsum over a whole chunk reaches ~1e6-1e9 with
post-trunc_exp densities and the per-ray difference of two such prefixes
loses its low bits. The port takes the other exact route: the prefix is a
float64 cumsum, the per-ray difference is taken in float64 and rounded once
to float32. The 'scan' segment sums use float64 prefixes too, so they carry
none of the reference's ~2e-3 prefix-rounding error.
"""

from __future__ import annotations

import torch


def composite_dense(sigmas: torch.Tensor, rgbs: torch.Tensor,
                    deltas: torch.Tensor, ts: torch.Tensor):
    """Per-ray sample grids: sigmas/deltas/ts [N, K], rgbs [N, K, 3] ->
    dict(weights [N, K], weights_sum [N], depth [N], image [N, 3])."""
    sdelta = sigmas * deltas
    cum = torch.cumsum(sdelta, dim=-1)
    trans = torch.exp(-(cum - sdelta))
    alpha = 1.0 - torch.exp(-sdelta)
    weights = trans * alpha
    return {"weights": weights, "weights_sum": weights.sum(-1),
            "depth": (weights * ts).sum(-1),
            "image": (weights[..., None] * rgbs).sum(-2)}


def _segment_sums(prefix: torch.Tensor, offsets: torch.Tensor,
                  ends: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of inclusive prefixes along the last dim: [C, N]."""
    m = prefix.shape[-1]
    end = prefix[:, (ends - 1).clamp(0, m - 1)] * (ends > 0)
    start = prefix[:, (offsets - 1).clamp(0, m - 1)] * (offsets > 0)
    return end - start


def composite_flat(sigmas: torch.Tensor, rgbs: torch.Tensor,
                   deltas: torch.Tensor, ts: torch.Tensor,
                   ray_id: torch.Tensor, offsets: torch.Tensor,
                   valid: torch.Tensor, num_rays: int,
                   seg_mode: str = "scatter"):
    """Composite a flat ray-contiguous buffer.

    sigmas/deltas/ts [M], rgbs [M, 3], ray_id [M], offsets [N] segment
    starts, valid [M]. seg_mode 'scatter' reduces per ray with index_add
    (any sample order); 'scan' differences prefix sums at the segment
    boundaries (needs the ray-contiguous offsets every march produces).
    Returns dict(weights [M], weights_sum [N], depth [N], image [N, 3]).
    """
    m = sigmas.shape[0]
    sdelta = torch.where(valid, sigmas * deltas, 0.0)
    cum = torch.cumsum(sdelta.to(torch.float64), dim=0)
    first = cum[offsets.clamp(0, m - 1)][ray_id]
    sd_first = sdelta[offsets.clamp(0, m - 1)][ray_id].to(torch.float64)
    # exclusive in-segment optical depth: inclusive prefix difference minus
    # the sample's own sdelta, plus the segment start's own sdelta
    tau = ((cum - first) - sdelta.to(torch.float64) + sd_first).to(torch.float32)
    alpha = 1.0 - torch.exp(-sdelta)
    weights = torch.where(valid, torch.exp(-tau) * alpha, 0.0)
    rgb_m = torch.where(valid[:, None], rgbs, 0.0)
    # channel-major [5, M]: a scan along the last (contiguous) dim; a scan
    # along dim 0 of [M, 5] runs a slow outer-dim kernel on the card
    chan = torch.cat([weights[None], (weights * ts)[None],
                      weights[None] * rgb_m.t()], dim=0)
    if seg_mode == "scan":
        ends = torch.cat([offsets[1:], offsets.new_full((1,), m)])
        seg = _segment_sums(torch.cumsum(chan.to(torch.float64), dim=1),
                            offsets, ends).to(torch.float32)
    elif seg_mode == "scatter":
        seg = chan.new_zeros((5, num_rays)).index_add_(1, ray_id, chan)
    else:
        raise ValueError(f"unknown seg_mode {seg_mode!r}")
    return {"weights": weights, "weights_sum": seg[0], "depth": seg[1],
            "image": seg[2:5].t()}
