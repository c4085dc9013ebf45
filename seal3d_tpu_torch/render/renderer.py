"""Volume renderer (port of seal3d_tpu/render/renderer.py `render_rays`).

`render_rays` marches a ray batch, queries the field once on the samples and
composites them. Its branches, as in the reference: the packed flat branch
(flat_frac < 1) with the two-level march (the -O eval and full-image point)
or the single-level march (the -O train point once the adaptive budget has
picked a bucket), and the [N, K] grid branch (flat_frac None: the train
steps before the first budget retune). The transmittance-terminated rounds,
the legacy flat path and the dense oracle raise NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch
from torch.profiler import record_function

from seal3d_tpu_torch.ops.composite import composite_dense, composite_flat
from seal3d_tpu_torch.ops.raymarch import (SQRT3, MarchedRays,
                                           march_rays_flat,
                                           march_rays_flat_2level,
                                           march_rays_grid)


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


def march_flat(rays_o, rays_d, bitfield, opts: RenderOptions,
               aabb: torch.Tensor,
               jitter: Optional[torch.Tensor] = None) -> MarchedRays:
    """The packed sample buffer the flat branch of `render_rays` feeds the
    field: the two-level march where `two_level_ok` (the eval point), else
    the single-level march (the train point)."""
    k = opts.budget_per_ray
    budget = flat_budget(rays_o.shape[0], opts)
    if opts.tl_kernel_ok(k, jitter):
        raise _not_ported("the ladder kernel K4 (RenderOptions.tl_kernel)",
                          "Other backends and families")
    if opts.two_level_ok(k):
        return march_rays_flat_2level(
            rays_o, rays_d, bitfield, bound=opts.bound,
            cascades=opts.cascades, max_steps=opts.max_steps, k=k,
            budget=budget, num_candidates=opts.num_candidates,
            perturb=jitter, min_near=opts.min_near, aabb=aabb,
            occ_stride=opts.occ_stride, coarse_steps=opts.coarse_steps,
            group=opts.tl_group, over=opts.tl_over, kg=opts.tl_kg,
            pool=opts.tl_pool)
    if (opts.group_compact or opts.flat_select != "sort" or opts.span_adaptive
            or opts.pack_shards > 1):
        raise NotImplementedError(
            "group_compact, flat_select='gather', span_adaptive and sharded "
            "packs are left out of the port (ROADMAP.md, 'Not to port')")
    return march_rays_flat(
        rays_o, rays_d, bitfield, bound=opts.bound, cascades=opts.cascades,
        dt_gamma=opts.dt_gamma, max_steps=opts.max_steps, k=k, budget=budget,
        num_candidates=opts.num_candidates, perturb=jitter,
        min_near=opts.min_near, aabb=aabb, occ_stride=opts.occ_stride,
        coarse_steps=opts.coarse_steps)


def render_rays(params, field, cfg, bitfield, rays_o, rays_d,
                opts: RenderOptions, bg_color=1.0,
                aabb: Optional[torch.Tensor] = None,
                jitter: Optional[torch.Tensor] = None):
    """Occupancy-grid fast path over a ray batch, differentiable in params.

    field: a module with `apply(params, cfg, x, d, valid=)` (models.ngp).
    bitfield: [C*H^3/8] uint8; rays_o, rays_d: [N, 3] (d unit-norm);
    jitter: [N] uniforms in [0, 1) that perturb each ray's march start (the
    reference's `perturb=True`, whose numbers it draws from `key`), or None.
    flat_frac None (or >= 1) selects the [N, K] grid branch, else the packed
    flat branch (march_flat).
    Returns dict(image [N, 3], depth [N], weights_sum [N], num_samples []).
    """
    n = rays_o.shape[0]
    k = opts.budget_per_ray
    if opts.bg_radius > 0:
        raise _not_ported("the background net", "Other backends and families")
    if opts.compaction != "topk":
        raise NotImplementedError("the legacy 'flat' compaction is left out of "
                                  "the port (ROADMAP.md, 'Not to port')")
    if opts.term_rounds > 1:
        raise _not_ported("transmittance-terminated rounds",
                          "Other backends and families")
    if aabb is None:
        aabb = torch.tensor(opts.aabb, dtype=torch.float32, device=rays_o.device)
    if opts.flat_frac is not None and opts.flat_frac < 1.0:
        with record_function("render.march"):
            mf = march_flat(rays_o, rays_d, bitfield, opts, aabb, jitter)
        with record_function("render.field"):
            sigma, rgb = field.apply(params, cfg, mf.xyzs, mf.dirs,
                                     valid=mf.valid)
        with record_function("render.composite"):
            sigma = torch.where(mf.valid, sigma * opts.density_scale, 0.0)
            out = composite_flat(sigma, rgb, mf.deltas, mf.ts, mf.ray_id,
                                 mf.offsets, mf.valid, n,
                                 seg_mode=opts.composite_seg)
        num_samples = mf.valid.sum()
    else:
        with record_function("render.march"):
            m = march_rays_grid(
                rays_o, rays_d, bitfield, bound=opts.bound,
                cascades=opts.cascades, dt_gamma=opts.dt_gamma,
                max_steps=opts.max_steps, k=k,
                num_candidates=opts.num_candidates, perturb=jitter,
                min_near=opts.min_near, aabb=aabb, occ_stride=opts.occ_stride,
                coarse_steps=opts.coarse_steps)
        with record_function("render.field"):
            # the reference queries every grid slot (no valid mask) here
            sigma, rgb = field.apply(params, cfg, m.xyzs.reshape(-1, 3),
                                     m.dirs.reshape(-1, 3))
        with record_function("render.composite"):
            sigma = torch.where(m.valid,
                                sigma.reshape(n, k) * opts.density_scale, 0.0)
            out = composite_dense(sigma, rgb.reshape(n, k, 3), m.deltas,
                                  m.ts, m.valid)
        num_samples = m.valid.sum()
    image = out["image"] + (1.0 - out["weights_sum"])[:, None] * bg_color
    return {"image": image, "depth": out["depth"],
            "weights_sum": out["weights_sum"], "num_samples": num_samples}
