"""TensoRF field, vector-matrix (VM) and CP decompositions (port of
seal3d_tpu/models/tensorf.py), as functions over a params dict with the
reference's keys and shapes:

    {"sigma_mat": [3 x [R, H, W]] (VM; [] for CP), "sigma_vec": [3 x [R, D]],
     "color_mat": [...], "color_vec": [...], "basis_mat": [{"w": [3R, 27]}],
     "color_net": [{"w": [in, out]}, ...], "aabb": [6],
     "bg_mat": [R_bg, H_bg, W_bg], "bg_net": [...]}  (the last two with
                                                      bg_radius > 0)

Density sums the rank products of three plane x line pairs (VM) or of three
lines (CP); colour features go through the basis matrix, a frequency
encoding and a 3x128 MLP. The factor lookups (`sample_plane`,
`sample_line`) are the reference's explicit bilinear / linear formula over
four / two gathers, zero outside [-1, 1] (not `F.grid_sample`), each one
autograd Function whose backward scatters the factor's cotangent with
`index_add_` from the saved corner indices and weights. The VM pairs go
through `ops/tensorf_vm.py`'s `vm_features`: on CUDA tensors a hand-written
kernel pair that gathers, blends and multiplies each plane x line product
in one pass and scatters its cotangents with run-merged 16-byte atomics;
on CPU tensors the composition of those Functions. CP, CCNeRF and the
background net call the Functions. Both paths run under
`span("tensorf.sample")`, their backwards under `span("tensorf.scatter")`,
and the module's host counters (`lookup_rows`, `scatter_rows`, ...) count
their work as calls are issued. The resolution surgeries
(`upsample_model`, `shrink_model`) run between train segments and return a
new params tree; the caller re-creates the optimizer state.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seal3d_tpu_torch.models.mlp import mlp_apply, mlp_init
from seal3d_tpu_torch.ops.freq import freq_encode, freq_encode_dim
from seal3d_tpu_torch.ops.morton import morton3d_invert
from seal3d_tpu_torch.ops.tensorf_vm import vm_features
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp
from seal3d_tpu_torch.utils.trace import span

# plane i spans world axes MAT_IDS[i]; line i spans axis VEC_IDS[i]
MAT_IDS = ((0, 1), (0, 2), (1, 2))
# the params' MLPs, whose weight gradients their casts sum over a data mesh
# (models/mlp.py; basis_mat is an fp32 product)
MLP_NETS = ("color_net", "bg_net")
VEC_IDS = (2, 1, 0)

# the factor lookups' work over the process, counted on the host as calls
# are issued (no device sync), by factor kind: rows x components gathered
# forward (`lookup_rows`) and scattered by the backward (`scatter_rows`),
# and the rows alone (`lookup_points`, `scatter_points`)
lookup_rows = {"plane": 0, "line": 0}
lookup_points = {"plane": 0, "line": 0}
scatter_rows = {"plane": 0, "line": 0}
scatter_points = {"plane": 0, "line": 0}
# the components the VM kernel's backward sent to the L2 by atomics (its
# run merge sends fewer than the 4 a plane row and 2 a line row that
# `scatter_rows` counts), by device: an int64 device tensor made on first
# use, added to on the device (read it after a sync)
scatter_atomic_comps = {}


@dataclass(frozen=True)
class TensoRFConfig:
    bound: float = 1.0
    decomposition: str = "vm"  # 'vm' | 'cp'
    resolution: Tuple[int, int, int] = (128, 128, 128)
    sigma_rank: Tuple[int, int, int] = (16, 16, 16)
    color_rank: Tuple[int, int, int] = (48, 48, 48)
    color_feat_dim: int = 27
    num_layers: int = 3
    hidden_dim: int = 128
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    bg_resolution: Tuple[int, int] = (512, 512)
    bg_rank: int = 8
    bg_radius: float = -1.0
    freq_degree: int = 2

    @cached_property
    def dir_enc_dim(self) -> int:
        return freq_encode_dim(3, self.freq_degree)


def init(cfg: TensoRFConfig, generator: Optional[torch.Generator] = None,
         device=None, resolution=None):
    """Random params with the reference's shapes and init distributions
    (factors 0.1 x normal, bias-free Kaiming-uniform MLPs), at `resolution`
    (default cfg.resolution)."""
    res = tuple(resolution or cfg.resolution)
    kw = dict(generator=generator, dtype=torch.float32)

    def normal(*shape):
        return (0.1 * torch.randn(shape, **kw)).to(device)

    def one_svd(ranks):
        mats, vecs = [], []
        for i in range(3):
            m0, m1 = MAT_IDS[i]
            if cfg.decomposition == "vm":
                mats.append(normal(ranks[i], res[m1], res[m0]))
            vecs.append(normal(ranks[i], res[VEC_IDS[i]]))
        return mats, vecs

    sigma_mat, sigma_vec = one_svd(cfg.sigma_rank)
    color_mat, color_vec = one_svd(cfg.color_rank)
    total_color_rank = (sum(cfg.color_rank) if cfg.decomposition == "vm"
                        else cfg.color_rank[0])
    feat_enc_dim = freq_encode_dim(cfg.color_feat_dim, cfg.freq_degree)
    color_dims = ([feat_enc_dim + cfg.dir_enc_dim]
                  + [cfg.hidden_dim] * (cfg.num_layers - 1) + [3])
    mkw = dict(generator=generator, device=device)
    params = {
        "sigma_mat": sigma_mat,
        "sigma_vec": sigma_vec,
        "color_mat": color_mat,
        "color_vec": color_vec,
        "basis_mat": [{"w": mlp_init([total_color_rank, cfg.color_feat_dim],
                                     **mkw)[0]["w"]}],
        "color_net": mlp_init(color_dims, **mkw),
        "aabb": torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3,
                             dtype=torch.float32, device=device),
    }
    if cfg.bg_radius > 0:
        params["bg_mat"] = normal(cfg.bg_rank, *cfg.bg_resolution)
        bg_dims = ([cfg.bg_rank + cfg.dir_enc_dim]
                   + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3])
        params["bg_net"] = mlp_init(bg_dims, **mkw)
    return params


# ------------------------------------------------------- interpolation cores

def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as min(max(x, lo), hi): at x == lo or hi the gradient is
    split in half, as JAX's is. The bounds are filled on x's device
    (`new_full`): a tensor made from host data would be a blocking copy."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _plane_corners(cx, cy, h: int, w: int, align_corners: bool):
    """(inside mask, first corner's flat index, fx, fy) of bilinear lookups
    at coords in [-1, 1]; cx indexes W, cy indexes H."""
    inside = (cx.abs() <= 1.0) & (cy.abs() <= 1.0)
    if align_corners:
        x = (_clip(cx, -1.0, 1.0) + 1.0) * 0.5 * (w - 1)
        y = (_clip(cy, -1.0, 1.0) + 1.0) * 0.5 * (h - 1)
    else:
        x = _clip((cx + 1.0) * 0.5 * w - 0.5, 0.0, w - 1.0)
        y = _clip((cy + 1.0) * 0.5 * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 2)
    return inside, y0 * w + x0, x - x0, y - y0


def _plane_blend(v, fx, fy, inside):
    v00, v01, v10, v11 = v
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return out * inside[None, :]


def _line_corners(c, d: int, align_corners: bool):
    """(inside mask, first corner's index, fx) of linear lookups."""
    inside = c.abs() <= 1.0
    if align_corners:
        x = (_clip(c, -1.0, 1.0) + 1.0) * 0.5 * (d - 1)
    else:
        x = _clip((c + 1.0) * 0.5 * d - 0.5, 0.0, d - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, d - 2)
    return inside, x0, x - x0


def _line_blend(v, fx, inside):
    v0, v1 = v
    return (v0 * (1 - fx) + v1 * fx) * inside[None, :]


def _rows(g, inside):
    """The cotangent [R, N] of a lookup as [N, R] rows, zero outside: the
    scatters add whole rows of R components into a factor laid out [cells,
    R], so that neighbouring threads add into neighbouring addresses where
    the [R, cells] layout has the rows of one cell, which neighbouring
    points share, contend for one address."""
    return g.T.contiguous() * inside[:, None]


def _slope(u, lo: float, hi: float, scale: float):
    """d(`_clip`(u, lo, hi) * scale) / du: `scale` inside, half of it at
    either bound (the split of JAX's clip), zero outside."""
    return (((u > lo) & (u < hi)).to(u.dtype)
            + 0.5 * ((u == lo) | (u == hi)).to(u.dtype)) * scale


def _coord_slope(c, n: int, align_corners: bool):
    """d(position in cells) / d(coordinate) of `_plane_corners` /
    `_line_corners` along an axis of n cells."""
    if align_corners:
        return _slope(c, -1.0, 1.0, 0.5 * (n - 1))
    return _slope((c + 1.0) * 0.5 * n - 0.5, 0.0, n - 1.0, 0.5 * n)


class _SamplePlane(torch.autograd.Function):
    """Bilinear lookup of a plane factor: four gathers and the blend
    forward; backward, the factor's cotangent as four `index_add_` scatters
    of [N, R] rows (`_rows`) from the saved corner index, weights and inside
    mask. The coordinates and the gathered corners are kept only where the
    coordinates need a cotangent: the blend's derivative along each axis."""

    @staticmethod
    def forward(ctx, plane, cx, cy, align_corners):
        with span("tensorf.sample"):
            r, h, w = plane.shape
            lookup_rows["plane"] += cx.shape[0] * r
            lookup_points["plane"] += cx.shape[0]
            inside, i00, fx, fy = _plane_corners(cx, cy, h, w, align_corners)
            flat = plane.reshape(r, h * w)
            v = (flat.index_select(1, i00), flat.index_select(1, i00 + 1),
                 flat.index_select(1, i00 + w),
                 flat.index_select(1, i00 + w + 1))
            keep = (cx, cy, *v) if any(ctx.needs_input_grad[1:3]) else ()
            ctx.save_for_backward(i00, fx, fy, inside, *keep)
            ctx.shape, ctx.align_corners = (r, h, w), align_corners
            return _plane_blend(v, fx, fy, inside)

    @staticmethod
    def backward(ctx, g):
        with span("tensorf.scatter"):
            i00, fx, fy, inside, *coords = ctx.saved_tensors
            r, h, w = ctx.shape
            d_plane = d_cx = d_cy = None
            if ctx.needs_input_grad[0]:
                scatter_rows["plane"] += i00.shape[0] * r
                scatter_points["plane"] += i00.shape[0]
                gm = _rows(g, inside)
                g0, g1 = gm * (1 - fy)[:, None], gm * fy[:, None]
                acc = g.new_zeros((h * w, r))
                acc.index_add_(0, i00, g0 * (1 - fx)[:, None])
                acc.index_add_(0, i00 + 1, g0 * fx[:, None])
                acc.index_add_(0, i00 + w, g1 * (1 - fx)[:, None])
                acc.index_add_(0, i00 + w + 1, g1 * fx[:, None])
                d_plane = acc.T.contiguous().view(r, h, w)
            if coords:
                cx, cy, v00, v01, v10, v11 = coords
                gi = g * inside[None, :]
                d_fx = (gi * ((v01 - v00) * (1 - fy)
                              + (v11 - v10) * fy)).sum(0)
                d_fy = (gi * ((v10 - v00) * (1 - fx)
                              + (v11 - v01) * fx)).sum(0)
                d_cx = d_fx * _coord_slope(cx, w, ctx.align_corners)
                d_cy = d_fy * _coord_slope(cy, h, ctx.align_corners)
            return d_plane, d_cx, d_cy, None


class _SampleLine(torch.autograd.Function):
    """Linear lookup of a line factor: two gathers and the blend forward;
    backward, two `index_add_` scatters (as `_SamplePlane`)."""

    @staticmethod
    def forward(ctx, line, c, align_corners):
        with span("tensorf.sample"):
            r, d = line.shape
            lookup_rows["line"] += c.shape[0] * r
            lookup_points["line"] += c.shape[0]
            inside, x0, fx = _line_corners(c, d, align_corners)
            v = (line.index_select(1, x0), line.index_select(1, x0 + 1))
            keep = (c, *v) if ctx.needs_input_grad[1] else ()
            ctx.save_for_backward(x0, fx, inside, *keep)
            ctx.shape, ctx.align_corners = (r, d), align_corners
            return _line_blend(v, fx, inside)

    @staticmethod
    def backward(ctx, g):
        with span("tensorf.scatter"):
            x0, fx, inside, *coords = ctx.saved_tensors
            r, d = ctx.shape
            d_line = d_c = None
            if ctx.needs_input_grad[0]:
                scatter_rows["line"] += x0.shape[0] * r
                scatter_points["line"] += x0.shape[0]
                gm = _rows(g, inside)
                acc = g.new_zeros((d, r))
                acc.index_add_(0, x0, gm * (1 - fx)[:, None])
                acc.index_add_(0, x0 + 1, gm * fx[:, None])
                d_line = acc.T.contiguous()
            if coords:
                c, v0, v1 = coords
                d_fx = (g * inside[None, :] * (v1 - v0)).sum(0)
                d_c = d_fx * _coord_slope(c, d, ctx.align_corners)
            return d_line, d_c, None


def sample_plane(plane: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                 align_corners: bool = True) -> torch.Tensor:
    """Bilinear sample of [R, H, W] at coords in [-1, 1] (zero outside); cx
    indexes W, cy indexes H. Returns [R, N]."""
    return _SamplePlane.apply(plane, cx, cy, align_corners)


def sample_line(line: torch.Tensor, c: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """Linear sample of [R, D] at coords in [-1, 1] (zero outside).
    Returns [R, N]."""
    return _SampleLine.apply(line, c, align_corners)


def _normalize(params, x):
    aabb = params["aabb"]
    return 2.0 * (x - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0


def _cp_product(vecs, xn):
    return (sample_line(vecs[0], xn[:, VEC_IDS[0]])
            * sample_line(vecs[1], xn[:, VEC_IDS[1]])
            * sample_line(vecs[2], xn[:, VEC_IDS[2]]))


def _sigma_feat(params, cfg, xn):
    if cfg.decomposition == "cp":
        return _cp_product(params["sigma_vec"], xn).sum(0)
    return vm_features(params["sigma_mat"], params["sigma_vec"], xn,
                       reduce=True)


def _color_feat(params, cfg, xn):
    if cfg.decomposition == "cp":
        feats = _cp_product(params["color_vec"], xn)                # [R, N]
    else:
        feats = vm_features(params["color_mat"], params["color_vec"], xn,
                            reduce=False)                           # [3R, N]
    return feats.T @ params["basis_mat"][0]["w"]


def density(params, cfg: TensoRFConfig, x: torch.Tensor):
    """x [M, 3] world positions -> {"sigma": [M], "geo_feat": None}."""
    xn = _normalize(params, x)
    return {"sigma": trunc_exp(_sigma_feat(params, cfg, xn)), "geo_feat": None}


def color(params, cfg: TensoRFConfig, x: torch.Tensor, d: torch.Tensor,
          geo_feat=None) -> torch.Tensor:
    """x [M, 3], d [M, 3] unit dirs -> rgb [M, 3] in [0, 1]."""
    feat = _color_feat(params, cfg, _normalize(params, x))
    h = torch.cat([freq_encode(feat, cfg.freq_degree),
                   freq_encode(d, cfg.freq_degree)], dim=-1)
    return torch.sigmoid(mlp_apply(params["color_net"], h))


def apply(params, cfg: TensoRFConfig, x: torch.Tensor, d: torch.Tensor,
          valid: Optional[torch.Tensor] = None):
    """(sigma [M], rgb [M, 3]). `valid` is accepted for the renderer's
    call and ignored: every row is evaluated, as in the reference."""
    return density(params, cfg, x)["sigma"], color(params, cfg, x, d)


def background(params, cfg: TensoRFConfig, sph: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    """The background net: sph [N, 2] (theta/pi, phi/pi on the background
    sphere, `ops.raymarch.sph_from_ray`), d [N, 3] -> rgb [N, 3]."""
    feats = sample_plane(params["bg_mat"], sph[:, 0], sph[:, 1]).T  # [N, R]
    h = torch.cat([freq_encode(d, cfg.freq_degree), feats], dim=-1)
    return torch.sigmoid(mlp_apply(params["bg_net"], h))


def density_loss(params, cfg: TensoRFConfig) -> torch.Tensor:
    """L1 sparsity penalty on the sigma factors: the sum of each factor's
    mean absolute value."""
    loss = 0.0
    for v in params["sigma_vec"]:
        loss = loss + v.abs().mean()
    if cfg.decomposition == "vm":
        for m in params["sigma_mat"]:
            loss = loss + m.abs().mean()
    return loss


# ------------------------------------------------------ resolution surgeries

def _resize(img: torch.Tensor, size) -> torch.Tensor:
    """[1, R, H, W] -> [1, R, *size], as jax.image.resize(method='linear'):
    half-pixel centres, a triangle filter widened when an axis shrinks."""
    return F.interpolate(img, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def upsample_model(params, cfg: TensoRFConfig, resolution: Sequence[int]):
    """Every factor resized to a new grid resolution (planes bilinearly,
    lines as [1, R, 1, D] images); the caller re-creates the optimizer
    state."""
    res = tuple(int(r) for r in resolution)
    out = dict(params)
    with torch.no_grad():
        for nm in ("sigma", "color"):
            if cfg.decomposition == "vm":
                out[f"{nm}_mat"] = [
                    _resize(p[None], (res[MAT_IDS[i][1]], res[MAT_IDS[i][0]]))[0]
                    for i, p in enumerate(out[f"{nm}_mat"])]
            out[f"{nm}_vec"] = [
                _resize(v[None, :, None, :], (1, res[VEC_IDS[i]]))[0, :, 0]
                for i, v in enumerate(out[f"{nm}_vec"])]
    return out


def shrink_model(params, cfg: TensoRFConfig, density_grid, mean_density: float,
                 density_thresh: float = 0.01, grid_size: int = 128):
    """Crop the factors to the occupied sub-box of the last cascade of the
    density grid and shrink `aabb` to it (host-side numpy over the
    reference's float64 arithmetic); the params unchanged when no cell is
    occupied."""
    aabb = params["aabb"].detach().cpu().numpy()
    bound = float(aabb[3])
    half_grid = bound / grid_size
    thresh = min(density_thresh, float(mean_density))
    grid = torch.as_tensor(density_grid).detach().cpu().numpy()
    valid = grid[-1] > thresh
    if not valid.any():
        return params
    codes = torch.from_numpy(np.nonzero(valid)[0].astype(np.int64))
    pos = morton3d_invert(codes).numpy()
    pos = (2 * pos / (grid_size - 1) - 1) * (bound - half_grid)
    min_pos = pos.min(0) - half_grid
    max_pos = pos.max(0) + half_grid

    res = np.array([params["sigma_vec"][i].shape[1] for i in (2, 1, 0)])
    units = (aabb[3:] - aabb[:3]) / res
    tl = np.clip(np.round((min_pos - aabb[:3]) / units).astype(int), 0, None)
    br = np.minimum(np.round((max_pos - aabb[:3]) / units).astype(int), res)

    out = dict(params)
    for nm in ("sigma", "color"):
        vecs, mats = [], []
        for i in range(3):
            v = VEC_IDS[i]
            vecs.append(out[f"{nm}_vec"][i][:, tl[v]:br[v]].clone())
            if cfg.decomposition == "vm":
                m0, m1 = MAT_IDS[i]
                mats.append(out[f"{nm}_mat"][i][:, tl[m1]:br[m1],
                                                tl[m0]:br[m0]].clone())
        out[f"{nm}_vec"] = vecs
        if cfg.decomposition == "vm":
            out[f"{nm}_mat"] = mats
    out["aabb"] = torch.from_numpy(
        np.concatenate([min_pos, max_pos]).astype(np.float32)).to(
        params["aabb"].device)
    return out


def n_to_reso(n_voxels: int, aabb) -> list:
    """Voxel count -> per-axis resolution over the box `aabb` [6]."""
    aabb = torch.as_tensor(aabb).detach().cpu().numpy()
    xyz = aabb[3:] - aabb[:3]
    voxel_size = float((xyz.prod() / n_voxels) ** (1.0 / 3.0))
    return [max(int(round(v / voxel_size)), 2) for v in xyz]
