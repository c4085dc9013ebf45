"""Volume renderer (port of seal3d_tpu/render/renderer.py `render_rays`,
`sample_pdf` and `render_rays_dense`).

`render_rays` marches a ray batch, queries the field once on the samples and
composites them. Its branches, as in the reference: the packed flat branch
(flat_frac < 1) with the two-level march (the -O eval and full-image point;
with `tl_kernel` its group plan comes from the ladder kernel K4), the
group-granular march (`group_compact`, where its gate holds) or the
single-level march (the -O train point once the adaptive budget has picked a
bucket, and every eval at bound > 1; uniform, cone-stepped or
span-adaptive ladder), its transmittance-terminated rounds (term_rounds > 1,
on either march), the [N, K] grid branch (flat_frac None: the train steps
before the first budget retune), and the legacy flat compaction
(compaction != 'topk': every candidate tested, scatter-packed into
N * budget_per_ray slots). `render_rays_dense` is the dense oracle:
stratified samples, then importance samples from their weights
(`--dense_render`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch

from seal3d_tpu_torch.ops.composite import composite_dense, composite_flat
from seal3d_tpu_torch.ops.raymarch import (SQRT3, MarchedRays,
                                           compact_flat_direct, group_plan,
                                           march_candidates, march_rays,
                                           march_rays_flat,
                                           march_rays_flat_2level,
                                           march_rays_flat_2level_kernel,
                                           march_rays_flat_grouped,
                                           march_rays_grid,
                                           near_far_from_aabb,
                                           pack_groups_expand_fine,
                                           sph_from_ray)
from seal3d_tpu_torch.utils.trace import span


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


def _background(field, params, cfg, opts: RenderOptions, rays_o, rays_d,
                bg_color):
    """What shows behind the samples: the field's background net at each
    ray's far point on the sphere of radius bg_radius, where the field has
    one, else bg_color."""
    if opts.bg_radius > 0 and getattr(field, "background", None) is not None:
        sph = sph_from_ray(rays_o, rays_d, opts.bg_radius)
        return field.background(params, cfg, sph, rays_d)
    return bg_color


def pack_shards(n: int, opts: RenderOptions) -> int:
    """Ray slices the flat pack of an n-ray batch is split into: pack_shards
    where it divides n, else 1 (the reference's fall-back)."""
    return opts.pack_shards if n % max(opts.pack_shards, 1) == 0 else 1


def flat_budget(n: int, opts: RenderOptions) -> int:
    """Flat sample budget of an n-ray batch: a multiple of 128 times its
    pack shards (Python round as in the reference)."""
    q = 128 * max(pack_shards(n, opts), 1)
    return max(int(round(n * opts.budget_per_ray * opts.flat_frac / q)) * q, q)


def round_budget_fracs(rounds: int) -> tuple:
    """Default per-round budget fractions of the single-round budget:
    geometric halving scaled to a total of 0.8 (the first round holds most
    of the tightened ladder's valid samples; termination thins the rest)."""
    raw = [0.5**r for r in range(rounds)]
    return tuple(0.8 * f / sum(raw) for f in raw)


def _rounds_ok(opts: RenderOptions) -> bool:
    """term_rounds applies on the packed flat branch when the candidate
    ladder divides into the rounds; otherwise one round renders."""
    return (opts.term_rounds > 1 and opts.flat_frac is not None
            and opts.flat_frac < 1.0
            and opts.num_candidates % opts.term_rounds == 0)


def _render_rounds(params, field, cfg, bitfield, rays_o, rays_d,
                   opts: RenderOptions, jitter, aabb):
    """Transmittance-terminated rounds (term_rounds > 1): the candidate
    ladder is built once; round r packs the valid samples of its column
    slice on rays still alive (optical depth below -log(term_thresh)) into
    its own budget, queries the field and composites them after the optical
    depth of the rounds before (composite_flat's tau_in / tau_out). Equal
    to the single-pass composite of the concatenated stream but for the
    samples of dead rays, whose weights are already below term_thresh.
    On the two-level march (where two_level_ok and the group columns divide
    into the rounds) level 1 runs once and each round packs, expands and
    fine-tests only the alive kept groups of its slice.
    -> (dict(image, depth, weights_sum), num_samples)."""
    n, k, rounds = rays_o.shape[0], opts.budget_per_ray, opts.term_rounds
    c = opts.num_candidates
    fracs = opts.term_budget_fracs or round_budget_fracs(rounds)
    if len(fracs) != rounds:
        raise ValueError(f"term_budget_fracs {fracs} has not {rounds} entries")
    base = n * k * opts.flat_frac
    tau_max = -math.log(opts.term_thresh)
    g = opts.tl_group
    two_level = opts.two_level_ok(k) and (c // g) % rounds == 0
    if two_level:
        plan = group_plan(rays_o, rays_d, bitfield, bound=opts.bound,
                          cascades=opts.cascades, max_steps=opts.max_steps,
                          k=k, num_candidates=c, group=g, perturb=jitter,
                          min_near=opts.min_near, aabb=aabb,
                          coarse_steps=opts.coarse_steps, kg=opts.tl_kg,
                          pool=opts.tl_pool)
        cs = c // g // rounds          # group columns a round
    else:
        ts, dts, valid = march_candidates(
            rays_o, rays_d, bitfield, opts.bound, opts.cascades,
            opts.dt_gamma, opts.max_steps, c, perturb=jitter,
            min_near=opts.min_near, aabb=aabb, occ_stride=opts.occ_stride,
            coarse_steps=opts.coarse_steps, span_adaptive=opts.span_adaptive)
        cs = c // rounds               # candidate columns a round
        k_r = max(-(-k // rounds), 1)
    tau = rays_o.new_zeros(n)
    image = rays_o.new_zeros((n, 3))
    depth = rays_o.new_zeros(n)
    wsum = rays_o.new_zeros(n)
    num_samples = torch.zeros((), dtype=torch.int64, device=rays_o.device)
    for r in range(rounds):
        budget = max(int(round(base * fracs[r] / 128)) * 128, 128)
        sl = slice(r * cs, (r + 1) * cs)
        alive = (tau < tau_max)[:, None]
        with span("render.march"):
            if two_level:
                budget_g = max(-(-int(round(budget * opts.tl_over))
                                 // (g * 16)) * 16, 16)
                mf = pack_groups_expand_fine(
                    plan, plan.keep[:, sl] & alive, r * cs, rays_o, rays_d,
                    bitfield, opts.bound, opts.cascades, g, budget, budget_g,
                    opts.occ_stride)
            else:
                mf = compact_flat_direct(ts[:, sl], dts[:, sl],
                                         valid[:, sl] & alive, rays_o, rays_d,
                                         k_r, budget)
        with span("render.field"):
            sigma, rgb = field.apply(params, cfg, mf.xyzs, mf.dirs,
                                     valid=mf.valid)
        with span("render.composite"):
            sigma = torch.where(mf.valid, sigma * opts.density_scale, 0.0)
            o = composite_flat(sigma, rgb, mf.deltas, mf.ts, mf.ray_id,
                               mf.offsets, mf.valid, n, tau_in=tau,
                               seg_mode=opts.composite_seg)
        tau = o["tau_out"]
        image = image + o["image"]
        depth = depth + o["depth"]
        wsum = wsum + o["weights_sum"]
        num_samples = num_samples + mf.valid.sum()
    return {"image": image, "depth": depth, "weights_sum": wsum}, num_samples


def _grouped_ok(opts: RenderOptions, budget: int) -> bool:
    """The reference's gate of the group-granular march: group_compact on
    the uniform ladder, groups of occ_stride > 1 that divide the candidates,
    k and the budget; elsewhere the single-level march renders."""
    s = opts.occ_stride
    return (opts.group_compact and opts.dt_gamma == 0.0
            and not opts.span_adaptive and s > 1
            and opts.num_candidates % s == 0
            and opts.budget_per_ray % s == 0 and budget % s == 0)


def march_flat(rays_o, rays_d, bitfield, opts: RenderOptions,
               aabb: torch.Tensor,
               jitter: Optional[torch.Tensor] = None,
               ladder_tables=None) -> MarchedRays:
    """The packed sample buffer the flat branch of `render_rays` feeds the
    field: the two-level march where `two_level_ok` (the eval point), its
    level 1 from the ladder kernel K4 where `tl_kernel_ok`; the
    group-granular march where `_grouped_ok`; else the single-level march
    (the train point) on opts.span_adaptive's ladder, packed by one sort
    whatever flat_select says (the reference's two packs give the same
    packing). `ladder_tables`: the kernel's `pack_tables(bitfield,
    opts.tl_pool)`, where the caller has built it."""
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
    if _grouped_ok(opts, budget):
        return march_rays_flat_grouped(
            rays_o, rays_d, bitfield, bound=opts.bound,
            cascades=opts.cascades, max_steps=opts.max_steps, k=k,
            budget=budget, num_candidates=opts.num_candidates,
            perturb=jitter, min_near=opts.min_near, aabb=aabb,
            occ_stride=opts.occ_stride, coarse_steps=opts.coarse_steps)
    return march_rays_flat(
        rays_o, rays_d, bitfield, bound=opts.bound, cascades=opts.cascades,
        dt_gamma=opts.dt_gamma, max_steps=opts.max_steps, k=k, budget=budget,
        num_candidates=opts.num_candidates, perturb=jitter,
        min_near=opts.min_near, aabb=aabb, occ_stride=opts.occ_stride,
        coarse_steps=opts.coarse_steps, span_adaptive=opts.span_adaptive,
        shards=pack_shards(rays_o.shape[0], opts))


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
    flat branch: in transmittance-terminated rounds where `_rounds_ok`
    (`_render_rounds`), else in one (march_flat, which takes
    `ladder_tables`). compaction != 'topk' selects the legacy flat march
    (`march_rays`, N * budget_per_ray slots) whatever flat_frac says; its
    field query takes no valid mask and its composite is the scatter one,
    as in the reference.
    With bg_radius > 0 the field's background net paints what the samples
    leave uncovered (`_background`).
    Returns dict(image [N, 3], depth [N], weights_sum [N], num_samples []).
    """
    n = rays_o.shape[0]
    k = opts.budget_per_ray
    if aabb is None:
        aabb = torch.tensor(opts.aabb, dtype=torch.float32, device=rays_o.device)
    if opts.compaction != "topk":
        with span("render.march"):
            mf = march_rays(
                rays_o, rays_d, bitfield, bound=opts.bound,
                cascades=opts.cascades, dt_gamma=opts.dt_gamma,
                max_steps=opts.max_steps, budget=n * k,
                num_candidates=opts.num_candidates, perturb=jitter,
                min_near=opts.min_near, aabb=aabb)
        with span("render.field"):
            sigma, rgb = field.apply(params, cfg, mf.xyzs, mf.dirs)
        with span("render.composite"):
            sigma = torch.where(mf.valid, sigma * opts.density_scale, 0.0)
            out = composite_flat(sigma, rgb, mf.deltas, mf.ts, mf.ray_id,
                                 mf.offsets, mf.valid, n)
        num_samples = mf.valid.sum()
    elif _rounds_ok(opts):
        out, num_samples = _render_rounds(params, field, cfg, bitfield,
                                          rays_o, rays_d, opts, jitter, aabb)
    elif opts.flat_frac is not None and opts.flat_frac < 1.0:
        with span("render.march"):
            mf = march_flat(rays_o, rays_d, bitfield, opts, aabb, jitter,
                            ladder_tables)
        with span("render.field"):
            sigma, rgb = field.apply(params, cfg, mf.xyzs, mf.dirs,
                                     valid=mf.valid)
        with span("render.composite"):
            sigma = torch.where(mf.valid, sigma * opts.density_scale, 0.0)
            out = composite_flat(sigma, rgb, mf.deltas, mf.ts, mf.ray_id,
                                 mf.offsets, mf.valid, n,
                                 seg_mode=opts.composite_seg)
        num_samples = mf.valid.sum()
    else:
        with span("render.march"):
            m = march_rays_grid(
                rays_o, rays_d, bitfield, bound=opts.bound,
                cascades=opts.cascades, dt_gamma=opts.dt_gamma,
                max_steps=opts.max_steps, k=k,
                num_candidates=opts.num_candidates, perturb=jitter,
                min_near=opts.min_near, aabb=aabb, occ_stride=opts.occ_stride,
                coarse_steps=opts.coarse_steps,
                span_adaptive=opts.span_adaptive)
        with span("render.field"):
            # the reference queries every grid slot (no valid mask) here
            sigma, rgb = field.apply(params, cfg, m.xyzs.reshape(-1, 3),
                                     m.dirs.reshape(-1, 3))
        with span("render.composite"):
            sigma = torch.where(m.valid,
                                sigma.reshape(n, k) * opts.density_scale, 0.0)
            out = composite_dense(sigma, rgb.reshape(n, k, 3), m.deltas,
                                  m.ts, m.valid)
        num_samples = m.valid.sum()
    bg = _background(field, params, cfg, opts, rays_o, rays_d, bg_color)
    image = out["image"] + (1.0 - out["weights_sum"])[:, None] * bg
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
        with torch.no_grad(), span("render.dense_coarse"):
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
    with span("render.field"):
        sigma, rgb = field.apply(params, cfg, xyz.reshape(-1, 3),
                                 rays_d[:, None].expand(xyz.shape)
                                 .reshape(-1, 3))
    with span("render.composite"):
        out = composite_dense(sigma.reshape(z.shape) * opts.density_scale,
                              rgb.reshape(*z.shape, 3), deltas_of(z), z)
    bg = _background(field, params, cfg, opts, rays_o, rays_d, bg_color)
    image = out["image"] + (1.0 - out["weights_sum"])[:, None] * bg
    return {"image": image, "depth": out["depth"],
            "weights_sum": out["weights_sum"],
            "num_samples": torch.tensor(z.numel(), device=dev)}
