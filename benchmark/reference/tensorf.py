"""Plain PyTorch reference of the TensoRF vector-matrix field (Chen et al.,
ECCV 2022, arXiv 2203.09517) at torch-ngp's `tensoRF/network.py` widths,
and of the Seal-3D local stage on it (`main_SealTensoRF.py`): the three
point shells with the frozen teacher's answers cached for them, and the
pretraining step, in which every leaf but `aabb` moves.

The field, as the paper and torch-ngp describe it: positions normalised to
[-1, 1] over `aabb`; three plane x line factor pairs (plane i spans the
axes MAT_IDS[i], its line the remaining axis), each sampled by
`F.grid_sample(align_corners=True)` (a line as a one-column image, as
TensoRF's code samples it); density the sum over pairs and ranks of plane
times line, through trunc_exp; colour features the pairs' products
stacked over ranks, through the [3R, 27] basis matrix, frequency-encoded
(degree 2) with the direction and through a 3-layer MLP of width 128 and
a sigmoid. Nothing of the program is imported.

Departures, each to state the program's layout or precision:
- every sampled feature is multiplied by the point's inside mask (|c| <= 1
  on every coordinate of the factor): `grid_sample`'s zero padding blends
  the border into points just outside [-1, 1], the program reads zero
  there, and the shells' points all lie inside;
- the MLP and the basis matrix are bias-free and stored [in, out], with
  bf16 MLP operands and fp32 accumulation, as the program's weights are;
- density and colour normalise the position each on its own, as the
  program does.

STATED is the configuration's precision (fp32 factors and features; bf16
MLP operands, fp32 accumulation; the basis matrix an fp32 product with
TF32 off); CONTROL is the next below each (bf16 factors and features, fp8
e4m3 MLP operands), as `ngp.CONTROL`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ngp
from benchmark.reference import seal as ref_seal
from benchmark.reference.ngp import CONTROL, STATED, Precision  # noqa: F401

# fp32 products are fp32 here, not TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MAT_IDS = ((0, 1), (0, 2), (1, 2))
VEC_IDS = (2, 1, 0)

flatten, unflatten_like = ngp.flatten, ngp.unflatten_like


# ----------------------------------------------------------------- weights

def color_dims(model: dict) -> list:
    """Widths of the colour MLP: the frequency-encoded basis output and
    direction, the hidden layers, 3."""
    enc = 1 + 2 * model["freq_degree"]
    return ([model["color_feat_dim"] * enc + 3 * enc]
            + [model["hidden_dim"]] * (model["num_layers"] - 1) + [3])


def factor_shapes(model: dict) -> list:
    """(key, index, shape) of every factor, in the program's layout: plane
    i [R_i, res[m1], res[m0]], line i [R_i, res[VEC_IDS[i]]]."""
    res = model["resolution"]
    out = []
    for nm in ("sigma", "color"):
        ranks = model[f"{nm}_rank"]
        for i, (m0, m1) in enumerate(MAT_IDS):
            out.append((f"{nm}_mat", i, (ranks[i], res[m1], res[m0])))
        for i in range(3):
            out.append((f"{nm}_vec", i, (ranks[i], res[VEC_IDS[i]])))
    return out


def make_params(model: dict, seed: int, device, factor_scale: float = 0.1):
    """TensoRF VM weights from the seed, made on `device` in two large draws
    of one generator: every factor uniform in +-factor_scale, the basis
    matrix and every MLP weight Kaiming-uniform (bound 1/sqrt(fan_in),
    torch.nn.Linear's), bias-free; `aabb` the cube of side 2 * bound."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    shapes = factor_shapes(model)
    sizes = [math.prod(s) for *_, s in shapes]
    u = (torch.rand((sum(sizes),), generator=gen, device=device)
         * (2.0 * factor_scale) - factor_scale)
    params = {"sigma_mat": [], "sigma_vec": [], "color_mat": [],
              "color_vec": []}
    at = 0
    for (key, _, shape), n in zip(shapes, sizes):
        params[key].append(u[at:at + n].reshape(shape).contiguous())
        at += n
    dims = color_dims(model)
    layers = ([("basis_mat", sum(model["color_rank"]),
                model["color_feat_dim"])]
              + [("color_net", a, b) for a, b in zip(dims[:-1], dims[1:])])
    u = torch.rand((sum(a * b for _, a, b in layers),), generator=gen,
                   device=device)
    params.update(basis_mat=[], color_net=[])
    at = 0
    for key, a, b in layers:
        bound = 1.0 / math.sqrt(a)
        params[key].append({"w": (u[at:at + a * b].reshape(a, b)
                                  * (2.0 * bound) - bound).contiguous()})
        at += a * b
    b = float(model["bound"])
    params["aabb"] = torch.tensor([-b] * 3 + [b] * 3, dtype=torch.float32,
                                  device=device)
    return params


# ------------------------------------------------------------------ field

def _factor(t: torch.Tensor, prec: Precision) -> torch.Tensor:
    return t if prec.encode is None else ngp._round(t, prec.encode)


def plane_sample(plane, cx, cy, prec: Precision = STATED):
    """[R, H, W] at (cx -> W, cy -> H) in [-1, 1] -> [R, N], zero outside."""
    grid = torch.stack([cx, cy], dim=-1).reshape(1, 1, -1, 2)
    out = F.grid_sample(_factor(plane, prec)[None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)[0, :, 0]
    inside = (cx.abs() <= 1.0) & (cy.abs() <= 1.0)
    return _factor(out * inside[None, :], prec)


def line_sample(line, c, prec: Precision = STATED):
    """[R, D] at c in [-1, 1] -> [R, N], zero outside: the line as a
    [R, D, 1] image sampled at (0, c)."""
    grid = torch.stack([torch.zeros_like(c), c], dim=-1).reshape(1, 1, -1, 2)
    out = F.grid_sample(_factor(line, prec)[None, :, :, None], grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)[0, :, 0]
    return _factor(out * (c.abs() <= 1.0)[None, :], prec)


def _pairs(params, nm: str, xn, prec) -> list:
    """The three plane x line products of `nm` ('sigma' or 'color'), each
    [R_i, N]."""
    return [plane_sample(params[f"{nm}_mat"][i], xn[:, m0], xn[:, m1], prec)
            * line_sample(params[f"{nm}_vec"][i], xn[:, VEC_IDS[i]], prec)
            for i, (m0, m1) in enumerate(MAT_IDS)]


def freq(x: torch.Tensor, degree: int) -> torch.Tensor:
    """[x, sin(x), cos(x), ..., sin(2^(F-1) x), cos(2^(F-1) x)]."""
    outs = [x]
    for f in range(degree):
        outs += [torch.sin(x * 2.0 ** f), torch.cos(x * 2.0 ** f)]
    return torch.cat(outs, dim=-1)


def _normalized(params, x):
    aabb = params["aabb"]
    return 2.0 * (x - aabb[:3]) / (aabb[3:] - aabb[:3]) - 1.0


def field(params, model: dict, x, d, prec: Precision = STATED):
    """(sigma [M], rgb [M, 3]) at world positions x and unit directions d."""
    sigma_feat = sum(p.sum(0) for p in
                     _pairs(params, "sigma", _normalized(params, x), prec))
    sigma = ngp._TruncExp.apply(sigma_feat)
    feats = torch.cat(_pairs(params, "color", _normalized(params, x), prec))
    feat = feats.T @ params["basis_mat"][0]["w"]
    h = torch.cat([freq(feat, model["freq_degree"]),
                   freq(d, model["freq_degree"])], dim=-1)
    return sigma, torch.sigmoid(ngp.mlp(params["color_net"], h, prec))


# --------------------------------------------------------------- shells

def teacher_query(params, model, points, dirs, prec=STATED, chunk=2 ** 18):
    with torch.no_grad():
        outs = [field(params, model, points[i:i + chunk], dirs[i:i + chunk],
                      prec) for i in range(0, points.shape[0], chunk)]
    return (torch.cat([s for s, _ in outs]), torch.cat([c for _, c in outs]))


def shells(mapper: dict, teacher, model, pretrain: dict, device,
           prec=STATED) -> dict:
    """{shell: dict(points, dirs, sigma, color)} of the local, surrounding
    and global shells, the teacher's answers cached (as `seal.shells`,
    with this field)."""
    b = model["bound"]
    aabb = np.array([[-b] * 3, [b] * 3], np.float32)
    probe = torch.tensor([1.0, 0.0, 0.0], device=device)
    out = {}
    pts, dir_set = ref_seal.sample_grid_points(mapper["fill_bound"],
                                               pretrain["local_point_step"],
                                               pretrain["local_angle_step"])
    p = torch.from_numpy(pts).to(device)
    mpts, mdirs, mask = ref_seal.map_to_origin(mapper, p,
                                               probe.expand(p.shape))
    keep = torch.nonzero(mask)[:, 0]
    dirs_k = dir_set[np.random.default_rng(0).integers(0, len(dir_set),
                                                        int(keep.shape[0]))]
    sigma, color = teacher_query(teacher, model, mpts[keep], mdirs[keep], prec)
    out["local"] = dict(points=p[keep],
                        dirs=torch.from_numpy(dirs_k).to(device),
                        sigma=sigma, color=color)
    sb = np.array(mapper["fill_bound"], np.float32).reshape(-1, 2, 3).copy()
    ext = pretrain["surrounding_bounds_extend"]
    sb[:, 0] = np.maximum(sb[:, 0] - ext, aabb[0])
    sb[:, 1] = np.minimum(sb[:, 1] + ext, aabb[1])
    for name, bounds, step in (("surrounding", sb,
                                pretrain["surrounding_point_step"]),
                               ("global", aabb[None],
                                pretrain["global_point_step"])):
        pts, dir_set = ref_seal.sample_grid_points(
            bounds, step, pretrain[f"{name}_angle_step"])
        p = torch.from_numpy(pts).to(device)
        keep = torch.nonzero(~ref_seal.map_to_origin(
            mapper, p, probe.expand(p.shape))[2])[:, 0]
        dirs_k = torch.from_numpy(dir_set[np.random.default_rng(1).integers(
            0, len(dir_set), int(keep.shape[0]))]).to(device)
        sigma, color = teacher_query(teacher, model, p[keep], dirs_k, prec)
        out[name] = dict(points=p[keep], dirs=dirs_k, sigma=sigma, color=color)
    return out


class RefPretrainer(ref_seal.RefPretrainer):
    """The TensoRF student's pretraining steps: every leaf but `aabb` (the
    factors, the basis matrix and the colour MLP) moves under Adam (b1 0.9,
    b2 0.99, eps 1e-15) at the constant rate `lr`, the EMA (0.95) runs over
    every leaf."""

    def __init__(self, model, lr, params, prec=STATED, ema_decay=0.95):
        super().__init__(model, lr, params, prec, ema_decay)
        self.moved = [k for k in self.params if k != "aabb"]
        self.mu = {k: torch.zeros_like(self.params[k]) for k in self.moved}
        self.nu = {k: torch.zeros_like(self.params[k]) for k in self.moved}

    def loss(self, params, batch):
        sigma, color = field(params, self.model, batch["points"],
                             batch["dirs"], prec=self.prec)
        w = batch["weight"]
        wsum = w.sum().clamp(min=1e-6)
        diff = (torch.log1p(sigma) - torch.log1p(batch["sigma"])).abs()
        return ((diff * w).sum() / wsum
                + ((color - batch["color"]).abs() * w[:, None]).sum()
                / (3 * wsum))
