"""Occupancy-grid ray marching (port of seal3d_tpu/ops/raymarch.py): the
single-level march (candidate ladder, uniform, cone-stepped or span-adaptive;
`[N, K]` grid and flat packed layouts), the group-granular march, the legacy scatter compaction, and the
two-level eval march, whose level 1 can come from the ladder kernel K4
(`ladder_plan_kernel`, `march_rays_flat_2level_kernel`).

The march keeps the reference's static-shape design (fixed candidate ladder,
occupancy tests as gathers, packing by one sort of unique flat-index keys,
graceful Bresenham thinning when demand exceeds a budget) so its packed
buffers match the reference slot for slot. Index tensors are int64 here (the
reference's int32); the float arithmetic follows the reference expression by
expression, including the jittered start `t0 + perturb * dt_min` and the
float32 Bresenham divisions, because the selected samples depend on their
exact rounding. Marching is a selection without gradient: nothing here
requires grad.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from seal3d_tpu_torch.ops.bitfield import GRID_SIZE, bitfield_lookup
from seal3d_tpu_torch.ops.morton import morton3d

SQRT3 = 1.7320508075688772


@functools.cache
def _mort_of_lin(res: int, device: torch.device) -> torch.Tensor:
    """MORT_OF_LIN[x*res^2 + y*res + z] = morton(x, y, z)."""
    r = torch.arange(res, device=device)
    return morton3d(torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                                dim=-1)).reshape(-1)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """[0, x0, x0+x1, ...] without the total (the reference's
    concatenate([0], cumsum(x)[:-1]))."""
    c = torch.cumsum(x, 0)
    return torch.cat([c.new_zeros(1), c[:-1]])


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.05):
    """Slab test of rays vs an AABB [6]; misses get near = far = 1e9."""
    inv_d = 1.0 / torch.where(rays_d.abs() > 1e-15, rays_d, 1e-15)
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    near = tmin.clamp(min=min_near)
    far = torch.maximum(tmax, near + 1e-6)
    miss = tmax < tmin
    return torch.where(miss, 1e9, near), torch.where(miss, 1e9, far)


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """Far intersection of each ray with the background sphere of `radius`
    -> [N, 2] (theta / (pi/2), phi / pi) in [-1, 1], the background net's
    coordinates (d need not be unit)."""
    dd = (rays_d * rays_d).sum(-1)
    od = (rays_o * rays_d).sum(-1)
    oo = (rays_o * rays_o).sum(-1)
    disc = (od * od - dd * (oo - radius * radius)).clamp(min=0.0)
    t = (-od + torch.sqrt(disc)) / dd.clamp(min=1e-15)
    p = rays_o + t[..., None] * rays_d
    theta = torch.atan2(p[..., 1], torch.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2)
                        ) / (math.pi / 2)
    phi = torch.atan2(p[..., 0], p[..., 2]) / math.pi
    return torch.stack([theta, phi], dim=-1)


def mip_from_pos(x: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """Smallest cascade whose [-2^c, 2^c] box contains x."""
    mx = x.abs().amax(-1)
    mip = torch.ceil(torch.log2(mx.clamp(min=1e-8)))
    return mip.clamp(0, max_cascade - 1).to(torch.int64)


def mip_from_dt(dt: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """Smallest cascade whose cell size exceeds dt."""
    mip = torch.ceil(torch.log2((dt * GRID_SIZE * 0.5).clamp(min=1e-8)))
    return mip.clamp(0, max_cascade - 1).to(torch.int64)


def occupancy_at(x: torch.Tensor, dt: torch.Tensor, bitfield: torch.Tensor,
                 cascades: int, bound: Optional[float] = None) -> torch.Tensor:
    """Occupancy bit for world positions x [..., 3] at step size dt [...]."""
    mip = torch.maximum(mip_from_pos(x, cascades), mip_from_dt(dt, cascades))
    mip_bound = torch.exp2(mip.to(torch.float32))
    if bound is not None:
        mip_bound = mip_bound.clamp(max=bound)
    cell = ((x / mip_bound[..., None] * 0.5 + 0.5) * GRID_SIZE).to(torch.int64)
    cell = cell.clamp(0, GRID_SIZE - 1)
    return bitfield_lookup(bitfield, mip, morton3d(cell))


def coarse_tighten(rays_o, rays_d, bitfield, nears, fars, cascades: int,
                   bound: float, n_steps: int = 64, dt_gamma: float = 0.0,
                   max_steps: int = 1024):
    """Per-ray [near, far] tightening from 16^3 coarse occupancy views (64
    consecutive bitfield bytes = one 8^3 fine block = one coarse cell). With
    several cascades (bound > 1) there is one view per mip, and each coarse
    sample is tested at the mip the fine march would use there: the larger
    of mip_from_pos and mip_from_dt under the fine ladder's dt schedule
    (clamp(t * dt_gamma, dt_min, dt_max), or dt_min when dt_gamma == 0)."""
    n = n_steps
    frac = (torch.arange(n, dtype=torch.float32, device=nears.device) + 0.5) / n
    tc = nears[:, None] + frac[None, :] * (fars - nears)[:, None]
    xyz = rays_o[:, None, :] + tc[..., None] * rays_d[:, None, :]
    if cascades == 1:
        coarse = bitfield.reshape(4096, 64).amax(-1) > 0
        cell = (((xyz / bound) * 0.5 + 0.5) * 16.0).clamp(0.0, 15.0) \
            .to(torch.int64)
        occ = coarse[morton3d(cell)]
    else:
        coarse = (bitfield.reshape(cascades, 4096, 64).amax(-1) > 0).reshape(-1)
        dt_min = 2.0 * SQRT3 / max_steps
        dt_max = 2.0 * SQRT3 * bound / GRID_SIZE
        if dt_gamma > 0.0:
            dt = (tc * dt_gamma).clamp(dt_min, dt_max)
        else:
            dt = torch.full_like(tc, dt_min)
        mip = torch.maximum(mip_from_pos(xyz, cascades),
                            mip_from_dt(dt, cascades))
        mip_bound = torch.exp2(mip.to(torch.float32)).clamp(max=bound)
        cell = ((xyz / mip_bound[..., None] * 0.5 + 0.5) * 16.0) \
            .clamp(0.0, 15.0).to(torch.int64)
        occ = coarse[mip * 4096 + morton3d(cell)]
    occ = occ & (tc < fars[:, None])
    any_hit = occ.any(dim=1)
    occ_i = occ.to(torch.uint8)
    first = torch.argmax(occ_i, dim=1).to(torch.float32)
    last = (n - 1 - torch.argmax(occ_i.flip(1), dim=1)).to(torch.float32)
    dt_c = (fars - nears) / n
    near2 = torch.maximum(nears + (first - 1.0) * dt_c, nears)
    far2 = torch.minimum(nears + (last + 2.0) * dt_c, fars)
    return (torch.where(any_hit, near2, fars), torch.where(any_hit, far2, fars))


def pooled_dilated(bitfield: torch.Tensor, cascades: int,
                   pool: int = 32) -> torch.Tensor:
    """pool^3 pooled + 3^3-dilated occupancy view, linear (x-major) order:
    [cascades * pool^3] bool. One byte = one 64^3 cell, 8 bytes = one 32^3
    cell (Morton order is hierarchical)."""
    if pool == 64:
        pooled = bitfield.reshape(cascades, 64**3) > 0
    elif pool == 32:
        pooled = bitfield.reshape(cascades, 32768, 8).amax(-1) > 0
    else:
        raise ValueError("pooled views exist at 32^3 and 64^3")
    dense = pooled[:, _mort_of_lin(pool, bitfield.device)]
    d = torch.nn.functional.pad(
        dense.reshape(cascades, pool, pool, pool), (1, 1, 1, 1, 1, 1))
    d = d[:, :-2] | d[:, 1:-1] | d[:, 2:]
    d = d[:, :, :-2] | d[:, :, 1:-1] | d[:, :, 2:]
    d = d[..., :-2] | d[..., 1:-1] | d[..., 2:]
    return d.reshape(-1)


def pooled_dilated32(bitfield: torch.Tensor, cascades: int) -> torch.Tensor:
    return pooled_dilated(bitfield, cascades, 32)


class MarchedRays(NamedTuple):
    """Flat, ray-contiguous compacted sample buffer (static budget M)."""

    xyzs: torch.Tensor     # [M, 3] sample positions
    dirs: torch.Tensor     # [M, 3] ray directions per sample
    deltas: torch.Tensor   # [M] step length (thinning-compensated)
    ts: torch.Tensor       # [M] distance along the ray
    ray_id: torch.Tensor   # [M] owning ray (clipped for invalid slots)
    valid: torch.Tensor    # [M] bool
    offsets: torch.Tensor  # [N] start of each ray's segment
    counts: torch.Tensor   # [N] kept samples per ray


class GroupPlan(NamedTuple):
    """Level-1 result of the two-level march."""

    t0: torch.Tensor      # [N] ladder start (near, perturbed)
    fars: torch.Tensor    # [N]
    stride: torch.Tensor  # [N] per-ray group subsample stride
    keep: torch.Tensor    # [N, CG] bool kept-group mask
    dt_min: float


def group_plan(rays_o, rays_d, bitfield, bound: float, cascades: int,
               max_steps: int, k: int, num_candidates: int, group: int = 8,
               perturb: Optional[torch.Tensor] = None, min_near: float = 0.05,
               aabb: Optional[torch.Tensor] = None, coarse_steps: int = 0,
               kg: int = 0, pool: int = 32) -> GroupPlan:
    """Level 1 of the two-level march: AABB clip, coarse tighten, group
    midpoint test against the dilated pooled view, per-ray group stride.
    kg: per-ray kept-group cap; 0 = k // group, -1 = no cap, > 0 explicit."""
    g = group
    c = num_candidates
    if c % g:
        raise ValueError("num_candidates must divide into groups")
    cg = c // g
    kg = cg if kg < 0 else (kg if kg > 0 else max(k // g, 1))
    dt_min = 2.0 * SQRT3 / max_steps
    if not (g - 1) * dt_min < 2.0 * bound / pool:
        raise ValueError("group span exceeds the pooled cell; the midpoint "
                         "test would not be conservative")
    if cascades != 1:
        raise ValueError("the two-level march is single-cascade")
    dev = rays_o.device
    if aabb is None:
        aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                            device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if coarse_steps > 0:
        nears, fars = coarse_tighten(rays_o, rays_d, bitfield, nears, fars,
                                     cascades, bound, n_steps=coarse_steps,
                                     max_steps=max_steps)
    t0 = nears
    if perturb is not None:
        t0 = t0 + perturb * dt_min

    gi = torch.arange(cg, dtype=torch.float32, device=dev)
    tm = t0[:, None] + (gi * g + (g - 1) * 0.5)[None, :] * dt_min
    xyz_m = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
    cell = ((xyz_m / bound * 0.5 + 0.5) * pool).clamp(0.0, pool - 1.0) \
        .to(torch.int64)
    lin = (cell[..., 0] * pool + cell[..., 1]) * pool + cell[..., 2]
    occ_g = pooled_dilated(bitfield, cascades, pool)[lin]
    t_first = t0[:, None] + (gi * g)[None, :] * dt_min
    valid_g = occ_g & (t_first < fars[:, None])

    rank = torch.cumsum(valid_g.to(torch.int64), dim=1)
    count = rank[:, -1:]
    stride = torch.ceil(count / kg).to(torch.int64).clamp(min=1)[:, 0]
    keep = valid_g & (((rank - 1) % stride[:, None]) == 0)
    return GroupPlan(t0=t0, fars=fars, stride=stride, keep=keep, dt_min=dt_min)


def _bresenham_keep(mask: torch.Tensor, budget: int) -> torch.Tensor:
    """Evenly thin a flat mask to ~budget members over its global rank; an
    identity under budget. float32 division and truncation exactly as the
    reference writes them: the kept set depends on their rounding."""
    r = torch.cumsum(mask.to(torch.int64), 0)
    s = torch.clamp(r[-1].to(torch.float32) / budget, min=1.0)
    return mask & ((r.to(torch.float32) / s).to(torch.int64)
                   != ((r - 1).to(torch.float32) / s).to(torch.int64))


def _pack(mask: torch.Tensor, budget: int):
    """Stable compaction of a flat mask into `budget` slots: the reference's
    single sort of unique keys (kept index, else index + n). Returns (source
    index per slot, slot valid)."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=mask.device)
    sel = torch.sort(torch.where(mask, idx, idx + n)).values[:budget]
    ok = sel < n
    return torch.where(ok, sel, sel - n), ok


def pack_groups_expand_fine(plan: GroupPlan, keep: torch.Tensor, col0: int,
                            rays_o, rays_d, bitfield, bound: float,
                            cascades: int, g: int, budget: int,
                            budget_g: int, occ_stride: int) -> MarchedRays:
    """Levels pack/2/repack of the two-level march over group columns
    [col0, col0 + keep.shape[1]): pack kept groups into budget_g slots,
    expand each to its g members, fine-test them against the bitfield,
    repack the fine-valid members into `budget` slots. Overflow of either
    budget thins evenly (Bresenham) and rescales each ray's deltas by its
    kept fraction."""
    n, csg = keep.shape
    dev = keep.device
    budget_g = min(budget_g, n * csg)

    keep_all = keep.reshape(-1)
    keepf = _bresenham_keep(keep_all, budget_g)
    counts_g_all = keep.sum(1)
    counts_g = keepf.reshape(n, csg).sum(1)
    gscale = counts_g_all.to(torch.float32) / counts_g.clamp(min=1)

    selg, kept_g = _pack(keepf, budget_g)
    ray_g = selg // csg
    gidx = selg % csg + col0

    t0_g = plan.t0[ray_g]
    far_g = plan.fars[ray_g]
    str_g = plan.stride[ray_g].to(torch.float32)
    ro_g = rays_o[ray_g]
    rd_g = rays_d[ray_g]
    j = torch.arange(g, dtype=torch.float32, device=dev)
    cand = gidx.to(torch.float32)[:, None] * g + j[None, :]
    ts_2 = t0_g[:, None] + cand * plan.dt_min
    xyz_2 = ro_g[:, None, :] + ts_2[..., None] * rd_g[:, None, :]
    dts_2 = (plan.dt_min * str_g)[:, None].expand(ts_2.shape)
    if occ_stride > 1 and g % occ_stride == 0:
        occ_f = occupancy_at(xyz_2[:, ::occ_stride], dts_2[:, ::occ_stride],
                             bitfield, cascades, bound)
        occ_f = occ_f.repeat_interleave(occ_stride, dim=1)
    else:
        occ_f = occupancy_at(xyz_2, dts_2, bitfield, cascades, bound)
    valid_2 = (kept_g[:, None] & occ_f & (ts_2 < far_g[:, None])
               & (xyz_2.abs().amax(-1) <= bound))

    v2_all = valid_2.reshape(-1)
    v2 = _bresenham_keep(v2_all, budget)
    sel2, valid_f = _pack(v2, budget)
    ray_id = ray_g[sel2 // g]
    ts_f = ts_2.reshape(-1)[sel2]
    dts_f = dts_2.reshape(-1)[sel2]
    rd = rays_d[ray_id]
    xyzs = rays_o[ray_id] + ts_f[:, None] * rd

    # per-ray fine counts: ray r's members occupy fine slots
    # [gstart_r*g, gend_r*g) of the ray-contiguous group pack
    gstarts = _excl_cumsum(counts_g)
    fs = gstarts.clamp(max=budget_g) * g
    fe = (gstarts + counts_g).clamp(max=budget_g) * g
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    cum0 = torch.cat([zero, torch.cumsum(v2.to(torch.int64), 0)])
    counts = cum0[fe] - cum0[fs]
    offsets = _excl_cumsum(counts)
    kept = (offsets + counts).clamp(max=budget) - offsets.clamp(max=budget)

    cum_all = torch.cat([zero, torch.cumsum(v2_all.to(torch.int64), 0)])
    counts_all_f = cum_all[fe] - cum_all[fs]
    fscale = counts_all_f.to(torch.float32) / counts.clamp(min=1)
    dts_f = dts_f * (gscale * fscale)[ray_id.clamp(0, n - 1)]
    return MarchedRays(
        xyzs=xyzs, dirs=rd, deltas=dts_f, ts=ts_f,
        ray_id=ray_id.clamp(0, n - 1), valid=valid_f,
        offsets=offsets.clamp(max=budget), counts=kept.clamp(min=0))


def march_rays_flat_2level(rays_o, rays_d, bitfield, bound: float,
                           cascades: int, max_steps: int, k: int, budget: int,
                           num_candidates: int,
                           perturb: Optional[torch.Tensor] = None,
                           min_near: float = 0.05,
                           aabb: Optional[torch.Tensor] = None,
                           occ_stride: int = 4, coarse_steps: int = 0,
                           group: int = 8, over: float = 1.5, kg: int = 0,
                           pool: int = 32) -> MarchedRays:
    """Two-level hierarchical flat march (uniform ladder, cascades == 1):
    group midpoints against the dilated pooled view, then only surviving
    groups reach the fine bitfield; two sort-packs into static budgets."""
    plan = group_plan(rays_o, rays_d, bitfield, bound=bound,
                      cascades=cascades, max_steps=max_steps, k=k,
                      num_candidates=num_candidates, group=group,
                      perturb=perturb, min_near=min_near, aabb=aabb,
                      coarse_steps=coarse_steps, kg=kg, pool=pool)
    budget_g = max(-(-int(round(budget * over)) // (group * 16)) * 16, 16)
    return pack_groups_expand_fine(plan, plan.keep, 0, rays_o, rays_d,
                                   bitfield, bound, cascades, group, budget,
                                   budget_g, occ_stride)


def ladder_plan_kernel(rays_o, rays_d, bitfield, bound: float, max_steps: int,
                       num_candidates: int, group: int, min_near: float,
                       aabb: Optional[torch.Tensor], coarse_steps: int,
                       pool: int = 64, tables=None):
    """(GroupPlan, fine_cnt [N] f32) through the fused ladder kernel K4
    (ops/ladder.py) in place of near_far_from_aabb + coarse_tighten +
    group_plan: kg = -1, no jitter, single cascade, occ_stride == group
    (callers gate: RenderOptions.tl_kernel_ok). fine_cnt is an upper bound
    of each ray's fine repack demand. `tables` is `pack_tables(bitfield,
    pool)` where the caller built it once for many chunks."""
    from seal3d_tpu_torch.ops.ladder import ladder_plan, pack_tables

    if aabb is None:
        aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                            device=rays_o.device)
    if tables is None:
        tables = pack_tables(bitfield, pool=pool)
    t0, fars, keep, cnt = ladder_plan(
        rays_o.contiguous(), rays_d.contiguous(), *tables, aabb, bound=bound,
        min_near=min_near, max_steps=max_steps, num_candidates=num_candidates, group=group,
        n_coarse=coarse_steps, pool=pool)
    stride = torch.ones((rays_o.shape[0],), dtype=torch.int64,
                        device=rays_o.device)
    return GroupPlan(t0=t0, fars=fars, stride=stride, keep=keep,
                     dt_min=2.0 * SQRT3 / max_steps), cnt


def march_rays_flat_2level_kernel(rays_o, rays_d, bitfield, bound: float,
                                  cascades: int, max_steps: int, k: int,
                                  budget: int, num_candidates: int,
                                  min_near: float = 0.05,
                                  aabb: Optional[torch.Tensor] = None,
                                  occ_stride: int = 4, coarse_steps: int = 32,
                                  group: int = 4, over: float = 1.5,
                                  pool: int = 64, tables=None) -> MarchedRays:
    """march_rays_flat_2level with its level 1 (the group plan) from the
    ladder kernel K4; pack, expand and repack are unchanged."""
    if cascades != 1:
        raise ValueError("the two-level march is single-cascade")
    plan, _ = ladder_plan_kernel(rays_o, rays_d, bitfield, bound, max_steps,
                                 num_candidates, group, min_near, aabb,
                                 coarse_steps, pool, tables=tables)
    budget_g = max(-(-int(round(budget * over)) // (group * 16)) * 16, 16)
    return pack_groups_expand_fine(plan, plan.keep, 0, rays_o, rays_d,
                                   bitfield, bound, cascades, group, budget,
                                   budget_g, occ_stride)


# ------------------------------------------------------ single-level march

def candidate_ts(nears: torch.Tensor, fars: torch.Tensor, num_steps: int,
                 dt_gamma: float, bound: float, max_steps: int,
                 perturb: Optional[torch.Tensor] = None,
                 span_adaptive: bool = False):
    """Cone-stepped candidate distances: (ts, dts, valid) [N, num_steps] with
    dt = clamp(t * dt_gamma, dt_min, dt_max); `perturb` [N] in [0, 1)
    jitters the start by up to one dt_min. span_adaptive (dt_gamma == 0
    only): each ray steps by its span / num_steps clipped to [dt_min,
    dt_max], so the ladder always covers [near, far]."""
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * bound / GRID_SIZE
    t0 = nears
    if perturb is not None:
        t0 = t0 + perturb * dt_min
    if dt_gamma <= 0.0:
        k = torch.arange(num_steps, dtype=torch.float32, device=nears.device)
        if span_adaptive:
            # max then min, as jnp.clip: no gradient passes through here
            dt_ray = ((fars - nears) / num_steps).clamp(min=dt_min) \
                .clamp(max=dt_max)
            ts = t0[:, None] + k[None, :] * dt_ray[:, None]
            dts = dt_ray[:, None].expand(ts.shape)
        else:
            ts = t0[:, None] + k[None, :] * dt_min
            dts = torch.full_like(ts, dt_min)
    else:  # the reference's lax.scan, one step per column
        t, ts_l, dts_l = t0, [], []
        for _ in range(num_steps):
            dt = (t * dt_gamma).clamp(dt_min, dt_max)
            ts_l.append(t)
            dts_l.append(dt)
            t = t + dt
        ts, dts = torch.stack(ts_l, 1), torch.stack(dts_l, 1)
    return ts, dts, ts < fars[:, None]


def march_candidates(rays_o, rays_d, bitfield, bound: float, cascades: int,
                     dt_gamma: float, max_steps: int,
                     num_candidates: Optional[int] = None,
                     perturb: Optional[torch.Tensor] = None,
                     min_near: float = 0.05,
                     aabb: Optional[torch.Tensor] = None,
                     occ_stride: int = 2, coarse_steps: int = 0,
                     span_adaptive: bool = False):
    """Occupancy-tested candidate ladder: (ts, dts, valid) [N, C] with
    validity = in-interval AND occupied AND in-bounds. Occupancy is tested
    at every occ_stride-th candidate and repeated to its neighbours."""
    if aabb is None:
        aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                            device=rays_o.device)
    if num_candidates is None:
        num_candidates = max_steps
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if coarse_steps > 0:
        nears, fars = coarse_tighten(rays_o, rays_d, bitfield, nears, fars,
                                     cascades, bound, n_steps=coarse_steps,
                                     dt_gamma=dt_gamma, max_steps=max_steps)
    ts, dts, valid = candidate_ts(nears, fars, num_candidates, dt_gamma,
                                  bound, max_steps, perturb,
                                  span_adaptive=span_adaptive)
    xyz = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    if occ_stride > 1 and num_candidates % occ_stride == 0:
        occ = occupancy_at(xyz[:, ::occ_stride], dts[:, ::occ_stride],
                           bitfield, cascades, bound)
        occ = occ.repeat_interleave(occ_stride, dim=1)
    else:
        occ = occupancy_at(xyz, dts, bitfield, cascades, bound)
    return ts, dts, valid & occ & (xyz.abs().amax(-1) <= bound)


class MarchedGrid(NamedTuple):
    """Per-ray fixed-K compacted samples: the [N, K] layout."""

    xyzs: torch.Tensor    # [N, K, 3]
    dirs: torch.Tensor    # [N, K, 3]
    deltas: torch.Tensor  # [N, K]
    ts: torch.Tensor      # [N, K]
    valid: torch.Tensor   # [N, K] bool


def ray_stride_keep(valid: torch.Tensor, k: int):
    """Per-ray stride subsample of over-k rays: (keep [N, C], stride [N, 1])
    keeping every stride-th valid candidate, stride = max(ceil(count/k), 1)."""
    rank = torch.cumsum(valid.to(torch.int64), dim=1)
    stride = torch.ceil(rank[:, -1:] / k).to(torch.int64).clamp(min=1)
    return valid & (((rank - 1) % stride) == 0), stride


def compact_topk(ts, dts, valid, rays_o, rays_d, k: int) -> MarchedGrid:
    """Select <= K kept candidates per ray in ascending t (the reference's
    top_k over kept-first scores, whose ties break toward the lower index:
    here the k smallest of the unique keys idx (kept) / idx + C (not kept));
    deltas scaled by the per-ray stride."""
    n, c = ts.shape
    keep, stride = ray_stride_keep(valid, k)
    dts = dts * stride.to(dts.dtype)
    idx = torch.arange(c, dtype=torch.int64, device=ts.device)[None, :]
    sel = torch.sort(torch.where(keep, idx, idx + c), dim=1).values[:, :k]
    sel = torch.sort(sel % c, dim=1).values
    ts_k = torch.gather(ts, 1, sel)
    xyz = rays_o[:, None, :] + ts_k[..., None] * rays_d[:, None, :]
    return MarchedGrid(xyzs=xyz, dirs=rays_d[:, None, :].expand(xyz.shape),
                       deltas=torch.gather(dts, 1, sel), ts=ts_k,
                       valid=torch.gather(keep, 1, sel))


def march_rays_grid(rays_o, rays_d, bitfield, bound: float, cascades: int,
                    dt_gamma: float, max_steps: int, k: int,
                    num_candidates: Optional[int] = None,
                    perturb: Optional[torch.Tensor] = None,
                    min_near: float = 0.05,
                    aabb: Optional[torch.Tensor] = None,
                    occ_stride: int = 2, coarse_steps: int = 0,
                    span_adaptive: bool = False) -> MarchedGrid:
    """Occupancy march into the per-ray [N, K] layout (compact_topk)."""
    ts, dts, valid = march_candidates(
        rays_o, rays_d, bitfield, bound, cascades, dt_gamma, max_steps,
        num_candidates, perturb=perturb, min_near=min_near, aabb=aabb,
        occ_stride=occ_stride, coarse_steps=coarse_steps,
        span_adaptive=span_adaptive)
    return compact_topk(ts, dts, valid, rays_o, rays_d, k)


def compact_grid_to_flat(m: MarchedGrid, budget: int) -> MarchedRays:
    """Pack the valid samples of an [N, K] march into a flat [budget] buffer
    in (ray, t) order; overflow drops the trailing rays' samples."""
    n, k = m.deltas.shape
    nk = n * k
    sel, valid_f = _pack(m.valid.reshape(-1), budget)
    ray_id = sel // k
    counts = m.valid.sum(1)
    starts = _excl_cumsum(counts)
    kept = (starts + counts).clamp(max=budget) - starts.clamp(max=budget)
    return MarchedRays(
        xyzs=m.xyzs.reshape(nk, 3)[sel], dirs=m.dirs.reshape(nk, 3)[sel],
        deltas=m.deltas.reshape(-1)[sel], ts=m.ts.reshape(-1)[sel],
        ray_id=ray_id.clamp(0, n - 1), valid=valid_f,
        offsets=starts.clamp(max=budget), counts=kept.clamp(min=0))


def compact_flat_direct(ts, dts, valid, rays_o, rays_d, k: int,
                        budget: int) -> MarchedRays:
    """Candidates [N, C] -> flat [budget] buffer in one sort: the per-ray
    stride subsample of compact_topk, graceful global overflow (Bresenham
    thinning over the global kept rank, each ray's deltas rescaled by its
    kept fraction), then the sort-pack of the kept flat indices."""
    n, c = ts.shape
    keep, stride = ray_stride_keep(valid, k)
    dts = dts * stride.to(dts.dtype)
    flat_keep = _bresenham_keep(keep.reshape(-1), budget)
    keep2 = flat_keep.reshape(n, c)
    counts_all = keep.sum(1)
    counts = keep2.sum(1)
    oscale = counts_all.to(torch.float32) / counts.clamp(min=1)
    sel, valid_f = _pack(flat_keep, budget)
    ts_f = ts.reshape(-1)[sel]
    ray_id = sel // c
    dts_f = dts.reshape(-1)[sel] * oscale[ray_id.clamp(0, n - 1)]
    rd = rays_d[ray_id]
    starts = _excl_cumsum(counts)
    kept = (starts + counts).clamp(max=budget) - starts.clamp(max=budget)
    return MarchedRays(
        xyzs=rays_o[ray_id] + ts_f[:, None] * rd, dirs=rd, deltas=dts_f,
        ts=ts_f, ray_id=ray_id.clamp(0, n - 1), valid=valid_f,
        offsets=starts.clamp(max=budget), counts=kept.clamp(min=0))


def compact_flat_sharded(ts, dts, valid, rays_o, rays_d, k: int,
                         budget: int, shards: int) -> MarchedRays:
    """`compact_flat_direct` per contiguous ray slice: slice s of the N rays
    packs into its own budget/shards sub-buffer, its ray_id and offsets
    moved by the slice's first ray and slot. What a data rank of the
    reference's mesh packs from its slice of the batch, so a rank marching
    its slice alone packs its part of this buffer. Under budget the
    selection equals the global pack's (slice-major is ray-major order);
    over budget only the Bresenham thinning becomes per slice. Pad slots
    carry valid=False. N and budget must divide by `shards` (the renderer
    rounds the budget to a multiple of 128 * shards)."""
    n = ts.shape[0]
    if n % shards or budget % shards:
        raise ValueError(f"compact_flat_sharded: {n} rays and budget "
                         f"{budget} must divide by {shards} shards")
    ns, bs = n // shards, budget // shards
    parts = []
    for s in range(shards):
        r = slice(s * ns, (s + 1) * ns)
        out = compact_flat_direct(ts[r], dts[r], valid[r], rays_o[r],
                                  rays_d[r], k, bs)
        parts.append(out._replace(ray_id=out.ray_id + s * ns,
                                  offsets=out.offsets + s * bs))
    return MarchedRays(*(torch.cat(f) for f in zip(*parts)))


def march_rays_flat(rays_o, rays_d, bitfield, bound: float, cascades: int,
                    dt_gamma: float, max_steps: int, k: int, budget: int,
                    num_candidates: Optional[int] = None,
                    perturb: Optional[torch.Tensor] = None,
                    min_near: float = 0.05,
                    aabb: Optional[torch.Tensor] = None,
                    occ_stride: int = 2,
                    coarse_steps: int = 0, span_adaptive: bool = False,
                    select: str = "sort", shards: int = 1) -> MarchedRays:
    """Occupancy march straight to the flat packed layout (the train fast
    path), packed by one sort (compact_flat_direct), per ray slice where
    shards > 1 (`compact_flat_sharded`). `select` is taken for the
    reference's signature and changes nothing: its 'gather' pack (rank
    inversion) gives the sort pack's packing, and packs slower on an H100
    (PERF.md)."""
    ts, dts, valid = march_candidates(
        rays_o, rays_d, bitfield, bound, cascades, dt_gamma, max_steps,
        num_candidates, perturb=perturb, min_near=min_near, aabb=aabb,
        occ_stride=occ_stride, coarse_steps=coarse_steps,
        span_adaptive=span_adaptive)
    if shards > 1:
        return compact_flat_sharded(ts, dts, valid, rays_o, rays_d, k,
                                    budget, shards)
    return compact_flat_direct(ts, dts, valid, rays_o, rays_d, k, budget)


def march_rays_flat_grouped(rays_o, rays_d, bitfield, bound: float,
                            cascades: int, max_steps: int, k: int,
                            budget: int, num_candidates: int,
                            perturb: Optional[torch.Tensor] = None,
                            min_near: float = 0.05,
                            aabb: Optional[torch.Tensor] = None,
                            occ_stride: int = 4,
                            coarse_steps: int = 0) -> MarchedRays:
    """Group-granular flat march (uniform ladder, dt_gamma == 0): select and
    pack run on [N, C/s] group representatives, the first of each run of
    s = occ_stride candidates (the occupancy bit is constant over the run).
    Over-budget rays keep every stride-th valid group (deltas times the
    stride), the budget is spent in whole groups (budget // s of them), and
    each kept group expands to its s candidates t0 + idx * dt_min. Members
    that fail ts < far or the bound at a ray's far end stay in its segment
    as valid=False slots, and `counts` includes them."""
    g = occ_stride
    n = rays_o.shape[0]
    cg = num_candidates // g
    kg = max(k // g, 1)
    budget_g = budget // g
    if aabb is None:
        aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                            device=rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    if coarse_steps > 0:
        nears, fars = coarse_tighten(rays_o, rays_d, bitfield, nears, fars,
                                     cascades, bound, n_steps=coarse_steps,
                                     max_steps=max_steps)
    dt_min = 2.0 * SQRT3 / max_steps
    t0 = nears
    if perturb is not None:
        t0 = t0 + perturb * dt_min
    gk = torch.arange(cg, dtype=torch.float32, device=rays_o.device) \
        * (g * dt_min)
    ts_g = t0[:, None] + gk[None, :]
    xyz_g = rays_o[:, None, :] + ts_g[..., None] * rays_d[:, None, :]
    occ = occupancy_at(xyz_g, torch.full_like(ts_g, dt_min), bitfield,
                       cascades, bound)
    valid_g = (ts_g < fars[:, None]) & occ & (xyz_g.abs().amax(-1) <= bound)
    keep, stride = ray_stride_keep(valid_g, kg)
    selg, kept_g = _pack(keep.reshape(-1), budget_g)
    ray_g = selg // cg
    j = torch.arange(g, dtype=torch.int64, device=rays_o.device)
    cand = ((selg % cg)[:, None] * g + j[None, :]).reshape(-1)
    ray_id = ray_g.repeat_interleave(g)
    ts_f = t0[ray_id] + cand.to(torch.float32) * dt_min
    dts_f = dt_min * stride[:, 0][ray_id].to(torch.float32)
    rd = rays_d[ray_id]
    xyzs = rays_o[ray_id] + ts_f[:, None] * rd
    valid_f = (kept_g.repeat_interleave(g) & (ts_f < fars[ray_id])
               & (xyzs.abs().amax(-1) <= bound))
    counts = keep.sum(1) * g
    starts = _excl_cumsum(counts)
    kept = (starts + counts).clamp(max=budget) - starts.clamp(max=budget)
    return MarchedRays(
        xyzs=xyzs, dirs=rd, deltas=dts_f, ts=ts_f,
        ray_id=ray_id.clamp(0, n - 1), valid=valid_f,
        offsets=starts.clamp(max=budget), counts=kept.clamp(min=0))


# ------------------------------------------------- legacy flat compaction

def compact_samples(ts, dts, valid, rays_o, rays_d,
                    budget: int) -> MarchedRays:
    """Candidates [N, T] -> flat [budget] buffer by cumsum slots (the
    reference's scatter compaction, RenderOptions.compaction='flat'):
    samples keep their (ray, t) order, and a sample whose slot falls past
    the budget is dropped, so the trailing rays lose theirs (no thinning).
    Slots no sample reaches hold zeros and valid=False."""
    n, t = ts.shape
    rank = torch.cumsum(valid.to(torch.int64), dim=1)
    counts = rank[:, -1]
    offsets = _excl_cumsum(counts)
    g = offsets[:, None] + rank - 1
    in_budget = valid & (g < budget) & (g >= 0)
    # source candidate of each slot; the dropped ones all land in the dump
    # slot `budget`, whose writes collide and are discarded
    src = torch.full((budget + 1,), -1, dtype=torch.int64, device=ts.device)
    src[torch.where(in_budget, g, budget).reshape(-1)] = torch.arange(
        n * t, dtype=torch.int64, device=ts.device)
    src = src[:budget]
    valid_f = src >= 0
    src = src.clamp(min=0)
    ray_id = torch.where(valid_f, src // t, 0)
    ts_f = torch.where(valid_f, ts.reshape(-1)[src], 0.0)
    rd = torch.where(valid_f[:, None], rays_d[ray_id], 0.0)
    xyzs = torch.where(valid_f[:, None], rays_o[ray_id] + ts_f[:, None] * rd,
                       0.0)
    kept = ((offsets + counts).clamp(max=budget)
            - offsets.clamp(max=budget)).clamp(min=0)
    return MarchedRays(
        xyzs=xyzs, dirs=rd, deltas=torch.where(valid_f, dts.reshape(-1)[src],
                                                0.0),
        ts=ts_f, ray_id=ray_id, valid=valid_f,
        offsets=offsets.clamp(max=budget), counts=kept)


def march_rays(rays_o, rays_d, bitfield, bound: float, cascades: int,
               dt_gamma: float, max_steps: int, budget: int,
               num_candidates: Optional[int] = None,
               perturb: Optional[torch.Tensor] = None,
               min_near: float = 0.05,
               aabb: Optional[torch.Tensor] = None) -> MarchedRays:
    """The legacy march: AABB clip, candidate ladder, a bit test at every
    candidate (no coarse tightening, no occ_stride), compact_samples."""
    ts, dts, valid = march_candidates(
        rays_o, rays_d, bitfield, bound, cascades, dt_gamma, max_steps,
        num_candidates, perturb=perturb, min_near=min_near, aabb=aabb,
        occ_stride=1)
    return compact_samples(ts, dts, valid, rays_o, rays_d, budget)
