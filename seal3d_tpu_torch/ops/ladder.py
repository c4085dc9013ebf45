"""Kernel K4: the fused ladder plan of the two-level eval march.

Replaces the Pallas kernel `ladder_plan` of the JAX package
(seal3d_tpu/ops/pallas/ladder.py, body `_kernel`). Per ray, in one pass:

  slab     near/far against the (occupancy-tightened) AABB; a miss gets
           near = far = 1e9
  coarse   n_coarse midpoints against the 16^3 view of the bitfield (one
           coarse cell = 64 consecutive Morton bytes); [near, far] shrinks
           to one step around the first and last occupied midpoint
  groups   CG group midpoints against the 3^3-dilated pool^3 view:
           keep[j] = occupied & (t0 + j*g*dt_min < far)
  demand   cnt = sum over kept groups of (bit of the 128^3 bitfield at the
           group's first candidate) * ceil(members of the group inside the
           interval): an upper bound of the fine repack's kept samples

`keep` equals `group_plan(..., kg=-1).keep` and (t0, far) equal
`coarse_tighten`'s; the eval demand probe is two sums of the outputs.
Single cascade, dt_gamma 0, no jitter, occ_stride == group: callers gate
(`RenderOptions.tl_kernel_ok`).

The TPU kernel reads its three tables as f32 "byte tables" through one-hot
MXU matmuls because a TPU cannot gather. Here the tables are bits
(`pack_tables`): the coarse view 512 bytes (Morton order), the dilated
pooled view pool^3 / 8 bytes (x-major linear order) and the bitfield itself
(256 KiB), all of which stay in L1/L2. The CUDA kernel (csrc/ladder.cu) runs
one warp per ray with no tile padding, so the reference's pad rays have no
counterpart. `ladder_plan_plain` writes the same expressions over [N] and
[N, CG] tensors in the same order: kept groups and cells depend on the exact
float32 rounding of the cell formulas.

`ladder_plan` dispatches on the rays' device: the plain version for CPU
tensors, the kernel for CUDA tensors (no fallback).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from seal3d_tpu_torch.ops.bitfield import GRID_BYTES
from seal3d_tpu_torch.ops.morton import morton3d

SQRT3 = 1.7320508075688772


def _packbits(mask: torch.Tensor) -> torch.Tensor:
    """[8n] bool -> [n] uint8, bit b of byte i = mask[8i + b]."""
    bits = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    return (mask.reshape(-1, 8).to(torch.int32) * bits).sum(-1).to(torch.uint8)


def _bit(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit `idx` of a packed uint8 table -> bool."""
    return ((table[idx >> 3].to(torch.int64) >> (idx & 7)) & 1).to(torch.bool)


def pack_tables(bitfield: torch.Tensor, pool: int = 64):
    """(coarse16 [512] uint8, pooled_dil [pool^3 / 8] uint8, bitfield) of a
    single-cascade occupancy bitfield: the 16^3 view in Morton order and the
    3^3-dilated pool^3 view in x-major linear order, both bit-packed like
    the bitfield. Built once per bitfield and shared by every chunk."""
    from seal3d_tpu_torch.ops.raymarch import pooled_dilated

    if bitfield.dtype != torch.uint8 or bitfield.shape != (GRID_BYTES,):
        raise ValueError(f"pack_tables needs a single-cascade uint8 bitfield "
                         f"[{GRID_BYTES}]; got {bitfield.dtype} "
                         f"{tuple(bitfield.shape)}")
    coarse = bitfield.reshape(4096, 64).amax(-1) > 0
    return (_packbits(coarse), _packbits(pooled_dilated(bitfield, 1, pool)),
            bitfield)


def _check_static(max_steps, num_candidates, group, n_coarse, pool):
    if group < 1 or num_candidates % group or n_coarse < 1:
        raise ValueError("ladder_plan: num_candidates must divide into "
                         "groups and n_coarse must be positive")
    if pool not in (32, 64):
        raise ValueError("pooled views exist at 32^3 and 64^3")
    return num_candidates // group, 2.0 * SQRT3 / max_steps


def ladder_plan_plain(rays_o, rays_d, coarse16, pooled_dil, fine, aabb,
                      bound: float, min_near: float, max_steps: int,
                      num_candidates: int, group: int, n_coarse: int = 32,
                      pool: int = 64):
    """Plain PyTorch K4 -> (t0 [N], fars [N], keep [N, CG] bool, cnt [N])."""
    cg, dt_min = _check_static(max_steps, num_candidates, group, n_coarse,
                               pool)
    g = group
    dev = rays_o.device

    def f32(v):  # a device scalar: tensor / tensor is a true division
        return torch.tensor(v, dtype=torch.float32, device=dev)

    bound_t, mb_t = f32(bound), f32(min(1.0, bound))
    aabb = aabb.to(torch.float32)

    # slab test
    inv = 1.0 / torch.where(rays_d.abs() > 1e-15, rays_d, 1e-15)
    ta = (aabb[:3] - rays_o) * inv
    tb = (aabb[3:] - rays_o) * inv
    tmin = torch.minimum(ta, tb).amax(-1)
    tmax = torch.maximum(ta, tb).amin(-1)
    near = tmin.clamp(min=min_near)
    far = torch.maximum(tmax, near + 1e-6)
    miss = tmax < tmin
    near = torch.where(miss, 1e9, near)
    far = torch.where(miss, 1e9, far)

    def cells(t, div, n):
        """Integer cells [..., 3] of the points at distances t [N, S]."""
        p = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
        return ((p / div * 0.5 + 0.5) * float(n)).clamp(0.0, n - 1.0) \
            .to(torch.int64)

    # coarse tighten
    dt_c = (far - near) / f32(float(n_coarse))
    fi = torch.arange(n_coarse, dtype=torch.float32, device=dev)
    tc = near[:, None] + (fi + 0.5)[None, :] * dt_c[:, None]
    occ = _bit(coarse16, morton3d(cells(tc, bound_t, 16))) \
        & (tc < far[:, None])
    any_hit = occ.any(dim=1)
    occ_i = occ.to(torch.uint8)
    first = torch.argmax(occ_i, dim=1).to(torch.float32)
    last = (n_coarse - 1 - torch.argmax(occ_i.flip(1), dim=1)) \
        .to(torch.float32)
    near2 = torch.maximum(near + (first - 1.0) * dt_c, near)
    far2 = torch.minimum(near + (last + 2.0) * dt_c, far)
    near2 = torch.where(any_hit, near2, far)
    far2 = torch.where(any_hit, far2, far)

    # group test
    fj = torch.arange(cg, dtype=torch.float32, device=dev)
    tm = near2[:, None] + (fj * g + (g - 1) * 0.5)[None, :] * dt_min
    c = cells(tm, bound_t, pool)
    lin = (c[..., 0] * pool + c[..., 1]) * pool + c[..., 2]
    t_first = near2[:, None] + (fj * g)[None, :] * dt_min
    keep = _bit(pooled_dil, lin) & (t_first < far2[:, None])

    # fine demand
    occ_f = _bit(fine, morton3d(cells(t_first, mb_t, 128)))
    n_cand = ((far2 - near2) / f32(dt_min)).clamp(min=0.0)
    members = (n_cand[:, None] - (fj * g)[None, :]).clamp(0.0, float(g))
    cnt = torch.where(keep & occ_f, torch.ceil(members), 0.0).sum(1)
    return near2, far2, keep, cnt


def ladder_plan(rays_o, rays_d, coarse16, pooled_dil, fine, aabb,
                bound: float, min_near: float, max_steps: int,
                num_candidates: int, group: int, n_coarse: int = 32,
                pool: int = 64):
    """K4 -> (t0 [N] f32, fars [N] f32, keep [N, CG] bool, cnt [N] f32).
    rays_o, rays_d [N, 3] f32; the tables of `pack_tables`; aabb [6]. CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    in `ladder_plan.launches`)."""
    args = (rays_o, rays_d, coarse16, pooled_dil, fine, aabb, bound,
            min_near, max_steps, num_candidates, group, n_coarse, pool)
    if rays_o.device.type == "cpu":
        return ladder_plan_plain(*args)
    if rays_o.device.type != "cuda":
        raise ValueError(f"ladder_plan: unsupported device {rays_o.device}")
    return _launch(*args)


ladder_plan.launches = 0


@functools.cache
def _entry(name: str):
    from seal3d_tpu_torch.runtime.build import load_library

    return bind_entry(load_library(), name)


def bind_entry(lib: ctypes.CDLL, name: str):
    """The C entry `name` (ladder_plan) of a build of csrc/ladder.cu, with
    its argument types set."""
    fn = getattr(lib, name)
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i64, f32, f32, f32, i32,
                   i32, i32, i32, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(rays_o, rays_d, coarse16, pooled_dil, fine, aabb, bound,
            min_near, max_steps, num_candidates, group, n_coarse, pool):
    cg, dt_min = _check_static(max_steps, num_candidates, group, n_coarse,
                               pool)
    dev = rays_o.device
    n = rays_o.shape[0]
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if (t.device != dev or t.dtype != torch.float32
                or t.shape != (n, 3) or not t.is_contiguous()):
            raise ValueError(f"ladder_plan {name} must be a contiguous f32 "
                             f"[N, 3] tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t, size in (("coarse16", coarse16, 512),
                          ("pooled_dil", pooled_dil, pool**3 // 8),
                          ("fine", fine, GRID_BYTES)):
        if (t.device != dev or t.dtype != torch.uint8 or t.shape != (size,)
                or not t.is_contiguous()):
            raise ValueError(f"ladder_plan {name} must be a contiguous uint8 "
                             f"[{size}] tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if aabb.device != dev or aabb.shape != (6,):
        raise ValueError(f"ladder_plan aabb must be a [6] tensor on {dev}")
    aabb = aabb.to(torch.float32).contiguous()
    # one allocation for the three [N] outputs, one for keep
    t0, far, cnt = torch.empty((3, n), dtype=torch.float32, device=dev)
    keep = torch.empty((n, cg), dtype=torch.bool, device=dev)
    if n == 0:
        return t0, far, keep, cnt
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry("ladder_plan")(
            rays_o.data_ptr(), rays_d.data_ptr(), aabb.data_ptr(),
            coarse16.data_ptr(), pooled_dil.data_ptr(), fine.data_ptr(),
            t0.data_ptr(), far.data_ptr(), keep.data_ptr(), cnt.data_ptr(),
            n, bound, min_near, dt_min, cg, group, n_coarse, pool, stream)
    if rc != 0:
        raise RuntimeError(f"ladder_plan launch failed: CUDA error {rc}")
    ladder_plan.launches += 1
    return t0, far, keep, cnt
