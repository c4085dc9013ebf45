"""Volume renderer (port of seal3d_tpu/render/renderer.py `render_rays`,
`sample_pdf` and `render_rays_dense`).

`render_rays` marches a ray batch, queries the field once on the samples and
composites them. Its branches, as in the reference: the packed flat branch
(flat_frac < 1) with the two-level march (the -O eval and full-image point;
with `tl_kernel` its group plan comes from the ladder kernel K4)
or the single-level march (the -O train point once the adaptive budget has
picked a bucket, and every eval at bound > 1), and the [N, K] grid branch
(flat_frac None: the train steps before the first budget retune). The
transmittance-terminated rounds and the legacy flat path raise
NotImplementedError. `render_rays_dense` is the dense oracle: stratified
samples, then importance samples from their weights (`--dense_render`).
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
                                           march_rays_flat_2level_kernel,
                                           march_rays_grid,
                                           near_far_from_aabb)


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
               jitter: Optional[torch.Tensor] = None,
               ladder_tables=None) -> MarchedRays:
    """The packed sample buffer the flat branch of `render_rays` feeds the
    field: the two-level march where `two_level_ok` (the eval point), its
    level 1 from the ladder kernel K4 where `tl_kernel_ok`; else the
    single-level march (the train point). `ladder_tables`: the kernel's
    `pack_tables(bitfield, opts.tl_pool)`, where the caller has built it."""
    k = opts.budget_per_ray
    budget = flat_budget(rays_o.shape[0], opts)
    if opts.tl_kernel_ok(k, jitter):
        return march_rays_flat_2level_kernel(
            rays_o, rays_d, bitfield, bound=opts.bound,
            cascades=opts.cascades, max_steps=opts.max_steps, k=k,
            budget=budget, num_candidates=opts.num_candidates,
            min_near=opts.min_near, aabb=aabb, occ_stride=opts.occ_stride,
            coarse_steps=opts.coarse_steps, group=opts.tl_group,
            over=opts.tl_over, pool=opts.tl_pool, tables=ladder_tables)
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
                jitter: Optional[torch.Tensor] = None, ladder_tables=None):
    """Occupancy-grid fast path over a ray batch, differentiable in params.

    field: a module with `apply(params, cfg, x, d, valid=)` (models.ngp).
    bitfield: [C*H^3/8] uint8; rays_o, rays_d: [N, 3] (d unit-norm);
    jitter: [N] uniforms in [0, 1) that perturb each ray's march start (the
    reference's `perturb=True`, whose numbers it draws from `key`), or None.
    flat_frac None (or >= 1) selects the [N, K] grid branch, else the packed
    flat branch (march_flat, which takes `ladder_tables`).
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
            mf = march_flat(rays_o, rays_d, bitfield, opts, aabb, jitter,
                            ladder_tables)
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


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF samples of intervals: bins [N, K+1] edges, weights [N, K]
    -> [N, n_samples] positions. u: [N, n_samples] uniforms in [0, 1) (the
    reference draws them from its key), or None for the deterministic
    midpoints linspace(0.5 / n, 1 - 0.5 / n, n)."""
    n, k = weights.shape
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([pdf.new_zeros((n, 1)), torch.cumsum(pdf, -1)], -1)
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=weights.device).expand(n, n_samples)
    idx = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    idx = idx.clamp(0, k - 1)
    cdf_lo = torch.gather(cdf, 1, idx)
    cdf_hi = torch.gather(cdf, 1, idx + 1)
    bins_lo = torch.gather(bins, 1, idx)
    bins_hi = torch.gather(bins, 1, idx + 1)
    denom = torch.where(cdf_hi - cdf_lo < 1e-5, 1.0, cdf_hi - cdf_lo)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


def render_rays_dense(params, field, cfg, rays_o, rays_d, opts: RenderOptions,
                      bg_color=1.0, perturb: bool = False,
                      z_jitter: Optional[torch.Tensor] = None,
                      pdf_u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """The dense oracle: opts.num_steps stratified samples per ray over its
    interval in the scene box (opts.aabb), a coarse pass of `field.density` (no gradient) whose
    composite weights place opts.upsample_steps inverse-CDF samples, both
    sets merged in order, then one `field.apply` and `composite_dense`.
    perturb: jitter the stratified samples by z_jitter [N, num_steps] in
    [0, 1) (centred, times the sample spacing) and draw the importance
    samples from pdf_u [N, upsample_steps]; either, where None, is drawn
    from `generator`. Without perturb: no jitter, midpoint uniforms.
    Returns dict(image [N, 3], depth [N], weights_sum [N], num_samples []:
    the samples composited; the reference returns no count)."""
    if opts.bg_radius > 0:
        raise _not_ported("the background net", "Other backends and families")
    n, dev = rays_o.shape[0], rays_o.device
    aabb = torch.tensor(opts.aabb, dtype=torch.float32, device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, opts.min_near)
    nears = nears.clamp(max=100.0)   # keep missed rays finite
    fars = fars.clamp(max=100.1)
    k = opts.num_steps
    z = torch.linspace(0.0, 1.0, k, device=dev)
    z = nears[:, None] + (fars - nears)[:, None] * z[None, :]
    sample_dist = (fars - nears) / k
    if perturb:
        if z_jitter is None:
            z_jitter = torch.rand(z.shape, generator=generator, device=dev)
        z = z + (z_jitter - 0.5) * sample_dist[:, None]

    def positions(zv):
        xyz = rays_o[:, None] + zv[..., None] * rays_d[:, None]
        return xyz.clamp(-opts.bound, opts.bound)

    def deltas_of(zv):
        return torch.cat([torch.diff(zv, dim=-1), sample_dist[:, None]], -1)

    if opts.upsample_steps > 0:
        with torch.no_grad(), record_function("render.dense_coarse"):
            sigma_c = field.density(params, cfg,
                                    positions(z).reshape(-1, 3))["sigma"]
            sigma_c = sigma_c.reshape(z.shape) * opts.density_scale
            w = composite_dense(sigma_c, z.new_zeros((*z.shape, 3)),
                                deltas_of(z), z)["weights"]
            if perturb and pdf_u is None:
                pdf_u = torch.rand((n, opts.upsample_steps),
                                   generator=generator, device=dev)
            new_z = sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w[:, 1:-1],
                               opts.upsample_steps,
                               u=pdf_u if perturb else None)
            z = torch.sort(torch.cat([z, new_z], -1), dim=-1).values

    xyz = positions(z)
    with record_function("render.field"):
        sigma, rgb = field.apply(params, cfg, xyz.reshape(-1, 3),
                                 rays_d[:, None].expand(xyz.shape)
                                 .reshape(-1, 3))
    with record_function("render.composite"):
        out = composite_dense(sigma.reshape(z.shape) * opts.density_scale,
                              rgb.reshape(*z.shape, 3), deltas_of(z), z)
    image = out["image"] + (1.0 - out["weights_sum"])[:, None] * bg_color
    return {"image": image, "depth": out["depth"],
            "weights_sum": out["weights_sum"],
            "num_samples": torch.tensor(z.numel(), device=dev)}
