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
encoding and a 3x128 MLP. The factor lookups live in ops/tensorf_vm.py:
`vm_features` for the VM pairs (on CUDA tensors a hand-written kernel pair
that gathers, blends and multiplies each plane x line product in one pass
and scatters its cotangents with run-merged 16-byte atomics), and
`sample_plane` / `sample_line` for CP and the background net; this module
binds them, their axes and their host counters (`lookup_rows`,
`scatter_rows`, ...) under the same names. The resolution surgeries
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

from seal3d_tpu_torch.ops.freq import freq_encode, freq_encode_dim
from seal3d_tpu_torch.ops.mlp import mlp_apply, mlp_init
from seal3d_tpu_torch.ops.morton import morton3d_invert
# the factor lookups, and their counters, which the benchmark reads as
# attributes of this module
from seal3d_tpu_torch.ops.tensorf_vm import (  # noqa: F401
    MAT_IDS, VEC_IDS, lookup_points, lookup_rows, sample_line, sample_plane,
    scatter_atomic_comps, scatter_points, scatter_rows, vm_features)
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp

# the params' MLPs, whose weight gradients their casts sum over a data mesh
# (ops/mlp.py; basis_mat is an fp32 product)
MLP_NETS = ("color_net", "bg_net")


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
