"""Volume renderer, two-level flat branch (port of
seal3d_tpu/render/renderer.py).

`render_rays` marches a ray batch with the two-level flat march, queries the
field once on the packed samples and composites them. It is the eval and
full-image path at the -O operating point. The reference's other branches
(single-level flat and transmittance-terminated rounds, the [N, K] grid path,
the legacy flat path, the dense oracle) raise NotImplementedError until their
slices land.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch

from seal3d_tpu_torch.ops.composite import composite_flat
from seal3d_tpu_torch.ops.raymarch import (SQRT3, MarchedRays,
                                           march_rays_flat_2level)


@dataclass(frozen=True)
class RenderOptions:
    """Static render options: the reference's fields and defaults (see its
    docstrings for each)."""

    bound: float = 1.0
    dt_gamma: float = 0.0
    max_steps: int = 1024
    budget_per_ray: int = 64
    num_candidates: int = 1024
    num_steps: int = 128
    upsample_steps: int = 128
    min_near: float = 0.2
    density_scale: float = 1.0
    bg_radius: float = -1.0
    compaction: str = "topk"
    occ_stride: int = 4
    flat_frac: Optional[float] = None
    coarse_steps: int = 0
    flat_select: str = "sort"
    pack_shards: int = 1
    span_adaptive: bool = False
    term_rounds: int = 1
    term_thresh: float = 1e-4
    term_budget_fracs: Optional[tuple] = None
    group_compact: bool = False
    march_two_level: bool = False
    tl_group: int = 8
    tl_pool: int = 32
    tl_over: float = 1.5
    tl_kg: int = 0
    composite_seg: str = "scatter"
    tl_kernel: bool = False

    def tl_kernel_ok(self, k: int, jitter) -> bool:
        return (self.tl_kernel and self.two_level_ok(k)
                and self.tl_kg == -1 and jitter is None
                and self.occ_stride == self.tl_group
                and self.coarse_steps > 0)

    def two_level_ok(self, k: int) -> bool:
        """Eligibility gate for the two-level march at this config."""
        dt_min = 2.0 * SQRT3 / self.max_steps
        return (self.march_two_level and self.dt_gamma == 0.0
                and self.cascades == 1 and not self.span_adaptive
                and self.num_candidates % self.tl_group == 0
                and (self.tl_group - 1) * dt_min
                < 2.0 * self.bound / self.tl_pool)

    @cached_property
    def cascades(self) -> int:
        return 1 + math.ceil(math.log2(self.bound)) if self.bound > 1 else 1

    @cached_property
    def aabb(self):
        b = self.bound
        return (-b, -b, -b, b, b, b)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue 1, "
                               f"'{item}'")


def flat_budget(n: int, opts: RenderOptions) -> int:
    """Flat sample budget of an n-ray batch (multiple of 128; Python round
    as in the reference)."""
    q = 128
    return max(int(round(n * opts.budget_per_ray * opts.flat_frac / q)) * q, q)


def march_eval(rays_o, rays_d, bitfield, opts: RenderOptions,
               aabb: torch.Tensor) -> MarchedRays:
    """The packed sample buffer the two-level branch of `render_rays`
    feeds the field."""
    k = opts.budget_per_ray
    if opts.compaction != "topk":
        raise NotImplementedError("the legacy 'flat' compaction is left out of "
                                  "the port (ROADMAP.md, 'Not to port')")
    if opts.term_rounds > 1:
        raise _not_ported("transmittance-terminated rounds",
                          "Other backends and families")
    if opts.flat_frac is None or opts.flat_frac >= 1.0:
        raise _not_ported("the [N, K] grid render path", "1l eval")
    if opts.tl_kernel_ok(k, None):
        raise _not_ported("the ladder kernel K4 (RenderOptions.tl_kernel)",
                          "Other backends and families")
    if not opts.two_level_ok(k):
        raise _not_ported("the single-level flat march", "1l eval")
    return march_rays_flat_2level(
        rays_o, rays_d, bitfield, bound=opts.bound, cascades=opts.cascades,
        max_steps=opts.max_steps, k=k, budget=flat_budget(rays_o.shape[0], opts),
        num_candidates=opts.num_candidates, min_near=opts.min_near, aabb=aabb,
        occ_stride=opts.occ_stride, coarse_steps=opts.coarse_steps,
        group=opts.tl_group, over=opts.tl_over, kg=opts.tl_kg,
        pool=opts.tl_pool)


def render_rays(params, field, cfg, bitfield, rays_o, rays_d,
                opts: RenderOptions, bg_color=1.0,
                aabb: Optional[torch.Tensor] = None):
    """Occupancy-grid fast path over a ray batch (two-level flat branch,
    unjittered: the train-time jitter comes with the training slice).

    field: a module with `apply(params, cfg, x, d, valid=)` (models.ngp).
    bitfield: [C*H^3/8] uint8; rays_o, rays_d: [N, 3] (d unit-norm).
    Returns dict(image [N, 3], depth [N], weights_sum [N], num_samples []).
    """
    n = rays_o.shape[0]
    if opts.bg_radius > 0:
        raise _not_ported("the background net", "Other backends and families")
    if aabb is None:
        aabb = torch.tensor(opts.aabb, dtype=torch.float32, device=rays_o.device)
    mf = march_eval(rays_o, rays_d, bitfield, opts, aabb)
    sigma, rgb = field.apply(params, cfg, mf.xyzs, mf.dirs, valid=mf.valid)
    sigma = torch.where(mf.valid, sigma * opts.density_scale, 0.0)
    out = composite_flat(sigma, rgb, mf.deltas, mf.ts, mf.ray_id, mf.offsets,
                         mf.valid, n, seg_mode=opts.composite_seg)
    image = out["image"] + (1.0 - out["weights_sum"])[:, None] * bg_color
    return {"image": image, "depth": out["depth"],
            "weights_sum": out["weights_sum"], "num_samples": mf.valid.sum()}
