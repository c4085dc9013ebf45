"""CCNeRF: the compressible and composable rank-residual tensor field (port of
seal3d_tpu/models/ccnerf.py), as functions over a params tree with the
reference's keys and shapes:

    {"objects": [{"vec_density": [{"U": [3 x [r, D]], "S": [1, r]}, ...],
                  "mat_density": [{"U": [3 x [r, H, W]], "S": [1, r]}, ...],
                  "vec_color": [... "S": [3C, r]], "mat_color": [...],
                  "aabb": [6], "T": [4, 4], "R": [3, 3]}, ...],
     "bg_mat": [R, H, W], "bg_S": [3C, R]}          (the last two with bg_radius)

Each family holds one entry per non-empty residual rank group (object 0 is
the trainable one). Training reads all K progressive reconstructions
(`apply_residual`: group k adds its vector and matrix parts to the sum of
the groups before it); colour is the SH encoding of the view direction
(degree 3) dotted with 3C features per point, no MLP. `finalize` sorts each
group's ranks by importance and fuses the groups, `compress` keeps the top
ranks of each family, `compose` adds another object with its rigid
transform and blends colours by the softmax of the objects' densities, and
`upsample_model` resizes the factors. The factor lookups are TensoRF's
`sample_plane` / `sample_line` (ops/tensorf_vm.py) with align_corners False.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from seal3d_tpu_torch.models.tensorf import _resize
from seal3d_tpu_torch.ops.sh import sh_encode, sh_encode_dim
from seal3d_tpu_torch.ops.tensorf_vm import (MAT_IDS, VEC_IDS, sample_line,
                                             sample_plane)
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp

FAMILIES = ("vec_density", "mat_density", "vec_color", "mat_color")


@dataclass(frozen=True)
class CCNeRFConfig:
    """The reference's CCNeRFConfig: same fields and defaults (ranks are
    cumulative per residual group)."""

    bound: float = 1.0
    resolution: Tuple[int, int, int] = (300, 300, 300)
    rank_vec_density: Tuple[int, ...] = (8, 8, 8)
    rank_mat_density: Tuple[int, ...] = (0, 16, 24)
    rank_vec: Tuple[int, ...] = (24, 24, 24)
    rank_mat: Tuple[int, ...] = (0, 48, 72)
    degree: int = 3
    bg_resolution: Tuple[int, int] = (512, 512)
    bg_rank: int = 8
    bg_radius: float = -1.0

    @cached_property
    def out_dim(self) -> int:
        return 3 * sh_encode_dim(self.degree)

    @cached_property
    def K(self) -> int:
        return len(self.rank_vec)


def _groups(ranks) -> list:
    return [int(g) for g in np.diff(np.asarray(ranks), prepend=0)]


def init(cfg: CCNeRFConfig, generator: Optional[torch.Generator] = None,
         device=None, resolution=None):
    """Random params at `resolution` (default cfg.resolution): factors
    0.2 x normal, the S weights ones; empty groups are left out."""
    res = tuple(resolution or cfg.resolution)

    def normal(*shape):
        return (0.2 * torch.randn(shape, generator=generator,
                                  dtype=torch.float32)).to(device)

    def family(ranks, is_mat, out_dim):
        out = []
        for g in _groups(ranks):
            if g <= 0:
                continue
            u = [normal(g, res[MAT_IDS[i][1]], res[MAT_IDS[i][0]]) if is_mat
                 else normal(g, res[VEC_IDS[i]]) for i in range(3)]
            out.append({"U": u, "S": torch.ones((out_dim, g),
                                                dtype=torch.float32,
                                                device=device)})
        return out

    obj = {"vec_density": family(cfg.rank_vec_density, False, 1),
           "mat_density": family(cfg.rank_mat_density, True, 1),
           "vec_color": family(cfg.rank_vec, False, cfg.out_dim),
           "mat_color": family(cfg.rank_mat, True, cfg.out_dim),
           "aabb": torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3,
                                dtype=torch.float32, device=device),
           "T": torch.eye(4, dtype=torch.float32, device=device),
           "R": torch.eye(3, dtype=torch.float32, device=device)}
    params = {"objects": [obj]}
    if cfg.bg_radius > 0:
        params["bg_mat"] = normal(cfg.bg_rank, *cfg.bg_resolution)
        params["bg_S"] = torch.ones((cfg.out_dim, cfg.bg_rank),
                                    dtype=torch.float32, device=device)
    return params


def _group_feat(group, xn: torch.Tensor, is_mat: bool) -> torch.Tensor:
    """One rank group's [out_dim, N] contribution (triple product x S)."""
    u = group["U"]
    if is_mat:
        feats = (sample_plane(u[0], xn[:, MAT_IDS[0][0]], xn[:, MAT_IDS[0][1]],
                              False)
                 * sample_plane(u[1], xn[:, MAT_IDS[1][0]],
                                xn[:, MAT_IDS[1][1]], False)
                 * sample_plane(u[2], xn[:, MAT_IDS[2][0]],
                                xn[:, MAT_IDS[2][1]], False))
    else:
        feats = (sample_line(u[0], xn[:, VEC_IDS[0]], False)
                 * sample_line(u[1], xn[:, VEC_IDS[1]], False)
                 * sample_line(u[2], xn[:, VEC_IDS[2]], False))
    return group["S"] @ feats


def _features(obj, family_vec: str, family_mat: str, xn: torch.Tensor,
              residual: bool) -> torch.Tensor:
    """The residual sums over groups -> [K, out_dim, N] (residual) or the
    last one [out_dim, N]. Group k adds the k-th vector group and the k-th
    matrix group, each where the family still has one."""
    vecs, mats = obj[family_vec], obj[family_mat]
    outputs, y = [], 0.0
    for k in range(max(len(vecs), len(mats))):
        if k < len(vecs):
            y = y + _group_feat(vecs[k], xn, False)
        if k < len(mats):
            y = y + _group_feat(mats[k], xn, True)
        outputs.append(y)
    return torch.stack(outputs) if residual else outputs[-1]


def _normalize(obj, x: torch.Tensor) -> torch.Tensor:
    homo = torch.cat([x, torch.ones_like(x[:, :1])], -1)
    xt = (homo @ obj["T"].T)[:, :3]
    aabb = obj["aabb"]
    return 2.0 * (xt - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0


def _color_from_feats(cfg: CCNeRFConfig, feats: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """[..., 3C, N] features and dirs [N, 3] -> [..., N, 3], the SH dot."""
    enc_d = sh_encode(d, cfg.degree)                  # [N, C]
    h = feats.movedim(-2, -1)                         # [..., N, 3C]
    h = h.reshape(*h.shape[:-1], 3, enc_d.shape[-1])
    return (h * enc_d[..., None, :]).sum(-1)


def apply_residual(params, cfg: CCNeRFConfig, x: torch.Tensor,
                   d: torch.Tensor):
    """All K progressive reconstructions of object 0: sigma [K, N], rgb
    [K, N, 3]."""
    obj = params["objects"][0]
    xn = _normalize(obj, x)
    fd = _features(obj, "vec_density", "mat_density", xn, True)   # [K, 1, N]
    fc = _features(obj, "vec_color", "mat_color", xn, True)       # [K, 3C, N]
    return (trunc_exp(fd[:, 0, :]),
            torch.sigmoid(_color_from_feats(cfg, fc, d)))


def apply(params, cfg: CCNeRFConfig, x: torch.Tensor, d: torch.Tensor,
          valid: Optional[torch.Tensor] = None):
    """(sigma [N], rgb [N, 3]) of the final reconstruction; a scene of
    several objects sums their densities and blends their colour logits by
    the softmax of the densities. `valid` is taken for the renderer's call
    and ignored."""
    objs = params["objects"]
    if len(objs) == 1:
        obj = objs[0]
        xn = _normalize(obj, x)
        sigma = trunc_exp(_features(obj, "vec_density", "mat_density", xn,
                                    False)[0])
        fc = _features(obj, "vec_color", "mat_color", xn, False)
        return sigma, torch.sigmoid(_color_from_feats(cfg, fc, d))
    sigmas, hs = [], []
    for obj in objs:
        xn = _normalize(obj, x)
        sigmas.append(trunc_exp(_features(obj, "vec_density", "mat_density",
                                          xn, False)[0]))
        fc = _features(obj, "vec_color", "mat_color", xn, False)
        hs.append(_color_from_feats(cfg, fc, d @ obj["R"].T))
    ws = torch.softmax(torch.stack(sigmas), dim=0)
    rgb = torch.sigmoid(sum(h * w[:, None] for h, w in zip(hs, ws)))
    return sum(sigmas), rgb


def density(params, cfg: CCNeRFConfig, x: torch.Tensor) -> dict:
    sigma = 0.0
    for obj in params["objects"]:
        xn = _normalize(obj, x)
        sigma = sigma + trunc_exp(_features(obj, "vec_density", "mat_density",
                                            xn, False)[0])
    return {"sigma": sigma, "geo_feat": None}


def color(params, cfg: CCNeRFConfig, x: torch.Tensor, d: torch.Tensor,
          geo_feat=None) -> torch.Tensor:
    return apply(params, cfg, x, d)[1]


def background(params, cfg: CCNeRFConfig, sph: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    feats = params["bg_S"] @ sample_plane(params["bg_mat"], sph[:, 0],
                                          sph[:, 1], False)
    return torch.sigmoid(_color_from_feats(cfg, feats, d))


def density_loss(params, cfg: CCNeRFConfig) -> torch.Tensor:
    """L1 of object 0's density factors: the sum of each factor's mean
    |u|, its gradient +1 at 0 as jnp.abs's (torch.abs gives 0 there)."""
    loss = 0.0
    obj = params["objects"][0]
    for fam in ("vec_density", "mat_density"):
        for g in obj[fam]:
            for u in g["U"]:
                loss = loss + torch.where(u >= 0, u, -u).mean()
    return loss


# -------------------------------------------------------------- host surgery

def _finalize_family(groups: list) -> list:
    """Each group's ranks sorted by importance (|S| summed over outputs
    times each factor's norm; numpy's argsort of -importance, not stable,
    as the reference), then all groups fused into one."""
    if not groups:
        return groups
    sorted_groups = []
    for g in groups:
        s = g["S"].detach().cpu().numpy()
        imp = np.abs(s).sum(0)
        for u in g["U"]:
            un = u.detach().cpu().numpy()
            imp = imp * np.linalg.norm(un.reshape(un.shape[0], -1), axis=-1)
        order = torch.from_numpy(np.argsort(-imp)).to(g["S"].device)
        sorted_groups.append({"U": [u[order] for u in g["U"]],
                              "S": g["S"][:, order]})
    return [{"U": [torch.cat([g["U"][i] for g in sorted_groups], 0)
                   for i in range(3)],
             "S": torch.cat([g["S"] for g in sorted_groups], 1)}]


def finalize(params):
    """Every object's rank groups fused (ends rank-residual training)."""
    out = dict(params)
    out["objects"] = [dict(obj, **{fam: _finalize_family(obj[fam])
                                   for fam in FAMILIES})
                      for obj in params["objects"]]
    return out


def compress(params, ranks: Sequence[int]):
    """The top `ranks` = (vd, md, vc, mc) of each finalized family (a family
    cut to 0 is emptied)."""
    params = finalize(params)
    out = dict(params)
    objs = []
    for obj in params["objects"]:
        o = dict(obj)
        for fam, r in zip(FAMILIES, ranks):
            if not o[fam]:
                continue
            g = o[fam][0]
            o[fam] = [] if r == 0 else [{"U": [u[:r] for u in g["U"]],
                                         "S": g["S"][:, :r]}]
        objs.append(o)
    out["objects"] = objs
    return out


def compose(params, other, R=None, s=None, t=None):
    """The scene of `params` with `other`'s object 0 added (both finalized)
    at the model transform x_world = R * s @ x_obj + t."""
    params, other = finalize(params), finalize(other)
    R = np.eye(3, dtype=np.float32) if R is None else np.asarray(R, np.float32)
    s = 1.0 if s is None else float(s)
    t = np.zeros(3, np.float32) if t is None else np.asarray(t, np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R * s
    T[:3, 3] = t
    dev = other["objects"][0]["T"].device
    new_obj = dict(other["objects"][0])
    new_obj["T"] = torch.from_numpy(
        np.linalg.inv(T).astype(np.float32)).to(dev)
    new_obj["R"] = torch.from_numpy(np.ascontiguousarray(R.T)).to(dev)
    out = dict(params)
    out["objects"] = [dict(o) for o in params["objects"]] + [new_obj]
    return out


def upsample_model(params, cfg: CCNeRFConfig, resolution: Sequence[int]):
    """Object 0's factors resized to `resolution` (as jax.image.resize
    'linear', TensoRF's `_resize`); other objects are kept."""
    res = tuple(int(r) for r in resolution)
    obj = params["objects"][0]
    o = dict(obj)
    with torch.no_grad():
        for fam in ("vec_density", "vec_color"):
            o[fam] = [{"U": [_resize(g["U"][i][None, :, None, :],
                                     (1, res[VEC_IDS[i]]))[0, :, 0]
                             for i in range(3)], "S": g["S"]}
                      for g in obj[fam]]
        for fam in ("mat_density", "mat_color"):
            o[fam] = [{"U": [_resize(g["U"][i][None],
                                     (res[MAT_IDS[i][1]],
                                      res[MAT_IDS[i][0]]))[0]
                             for i in range(3)], "S": g["S"]}
                      for g in obj[fam]]
    out = dict(params)
    out["objects"] = [o] + list(params["objects"][1:])
    return out
