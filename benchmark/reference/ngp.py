"""Plain PyTorch reference of the NGP field that the Seal-3D local stage
distils, as Instant-NGP defines it (Mueller et al. 2022) and the port's
`bucket` grid backend lays it out: a 16-level hash grid, each level sized
natively (its dense cube, 8-aligned, at most T = 2^log2_hashmap_size rows;
levels whose cube exceeds T hashed with instant-ngp's primes), trilinear
interpolation, a 2x64 density MLP and a 3x64 colour MLP with bf16 operands
and fp32 accumulation, SH degree 4, trunc_exp density. The grid encode is
a plain gather and weighted sum: no kernel of the program runs here, and
nothing of the program is imported.

`Precision` says how the field computes: STATED is the configuration's
(fp32 grid features, bf16 MLP operands); CONTROL is the next precision
below each (bf16 grid features, fp8 e4m3 MLP operands with a per-tensor
scale), the step that a later change could be tempted to take.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class Precision(NamedTuple):
    encode: Optional[torch.dtype]   # None: fp32 features
    mlp: torch.dtype                # operand precision of the MLP products


STATED = Precision(None, torch.bfloat16)
CONTROL = Precision(torch.bfloat16, torch.float8_e4m3fn)


# ----------------------------------------------------------------- trees

def flatten(tree, prefix: str = "") -> dict:
    """{'/'-joined path: tensor} of a nest of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_like(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: unflatten_like(v, flat, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return flat[prefix]


# ----------------------------------------------------------------- weights

def mlp_dims(model: dict) -> tuple:
    grid_dim = model["num_levels"] * model["level_dim"]
    sigma = ([grid_dim] + [model["hidden_dim"]] * (model["num_layers"] - 1)
             + [1 + model["geo_feat_dim"]])
    color = ([model["sh_degree"] ** 2 + model["geo_feat_dim"] + grid_dim]
             + [model["hidden_dim_color"]] * (model["num_layers_color"] - 1)
             + [3])
    return sigma, color


def make_params(model: dict, seed: int, device, table_scale: float = 1e-4):
    """NGP weights from the seed, made on `device` in two large draws of one
    generator: both tables uniform in +-table_scale, every MLP weight
    Kaiming-uniform (bound 1/sqrt(fan_in), torch.nn.Linear's), bias-free."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    rows = table_rows(model)
    f = model["level_dim"]
    tables = (torch.rand((2, rows, f), generator=gen, device=device)
              * (2.0 * table_scale) - table_scale)
    sigma, color = mlp_dims(model)
    shapes = ([("sigma_net", a, b) for a, b in zip(sigma[:-1], sigma[1:])]
              + [("color_net", a, b) for a, b in zip(color[:-1], color[1:])])
    u = torch.rand((sum(a * b for _, a, b in shapes),), generator=gen,
                   device=device)
    params = {"encoder": tables[0].contiguous(),
              "encoder_color": tables[1].contiguous(),
              "sigma_net": [], "color_net": []}
    at = 0
    for net, a, b in shapes:
        bound = 1.0 / math.sqrt(a)
        params[net].append({"w": (u[at:at + a * b].reshape(a, b)
                                  * (2.0 * bound) - bound).contiguous()})
        at += a * b
    return params


# ------------------------------------------------------------------ field

def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    """t computed at `dtype`, as fp32, with an identity gradient (bf16), or,
    for fp8, scaled per tensor to e4m3's range first."""
    if dtype == torch.float8_e4m3fn:
        s = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (t.detach() / s).to(dtype).to(torch.float32) * s
    else:
        q = t.detach().to(dtype).to(torch.float32)
    return t + (q - t.detach())


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def level_layout(model: dict) -> list:
    """Per level: (resolution, interpolation scale, first row, rows, hashed)
    of the native layout: a level holds its dense cube, 8-aligned, or T
    rows where the cube is larger, and is hashed there."""
    levels = model["num_levels"]
    base = model["base_resolution"]
    desired = int(model["desired_resolution"] * model["bound"])
    t_rows = 2 ** model["log2_hashmap_size"]
    g = math.exp(math.log(desired / base) / (levels - 1)) if levels > 1 else 1.0
    out, offset = [], 0
    for lvl in range(levels):
        scale = base * g ** lvl - 1.0
        res = int(math.ceil(scale)) + 2
        dense = res ** 3
        size = min((dense + 7) // 8 * 8, t_rows)
        out.append((res, scale, offset, size, dense > t_rows))
        offset += size
    return out


def table_rows(model: dict) -> int:
    _, _, offset, size, _ = level_layout(model)[-1]
    return offset + size


_CORNERS = [((i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8)]


def encode(table: torch.Tensor, xf: torch.Tensor, model: dict,
           prec: Precision = STATED) -> torch.Tensor:
    """Hash-grid encode of positions xf [M, 3] in [0, 1] -> [M, L*F]: per
    level, pos = clamp(x * scale + 0.5, 0, res - 1), the 8 corners clamped
    to the grid, their row x ^ y*p1 ^ z*p2 mod T (hashed levels) or
    x + y*res + z*res^2 (dense ones), weights the product of the axis
    fractions."""
    tab = table if prec.encode is None else _round(table, prec.encode)
    feats = []
    for res, scale, offset, size, hashed in level_layout(model):
        pos = (xf * scale + 0.5).clamp(0.0, float(res - 1))
        pos0 = torch.floor(pos)
        frac = pos - pos0
        p0 = pos0.to(torch.int64)
        acc = None
        for c in _CORNERS:
            cp = [(p0[:, d] + c[d]).clamp(max=res - 1) for d in range(3)]
            if hashed:
                row = ((cp[0] * _PRIMES[0]) ^ ((cp[1] * _PRIMES[1]) & _U32)
                       ^ ((cp[2] * _PRIMES[2]) & _U32)) & (size - 1)
            else:
                row = (cp[0] + cp[1] * res + cp[2] * res * res) \
                    .clamp(max=size - 1)
            w = None
            for d in range(3):
                fd = frac[:, d] if c[d] else 1.0 - frac[:, d]
                w = fd if w is None else w * fd
            term = tab.index_select(0, row + offset) * w[:, None]
            acc = term if acc is None else acc + term
        feats.append(acc)
    out = torch.cat(feats, dim=-1)
    return out if prec.encode is None else _round(out, prec.encode)


def mlp(layers, x: torch.Tensor, prec: Precision = STATED) -> torch.Tensor:
    """ReLU hidden layers, linear output; operands rounded to prec.mlp and
    multiplied in fp32 (a product of two bf16 values is exact in fp32)."""
    rnd = _bf16 if prec.mlp == torch.bfloat16 else (
        lambda t: _round(t, prec.mlp))
    h = rnd(x)
    for i, layer in enumerate(layers):
        h = h @ rnd(layer["w"])
        if i != len(layers) - 1:
            h = rnd(torch.relu(h))
    return h


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis of degree 4 (16 values), instant-ngp's constants."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=-1)


def field(params, model: dict, x, d, prec: Precision = STATED):
    """(sigma [M], rgb [M, 3]) at world positions x and unit directions d."""
    xf = (x + model["bound"]) / (2.0 * model["bound"])
    feat = encode(params["encoder"], xf, model, prec)
    cfe = encode(params["encoder_color"], xf, model, prec)
    h = mlp(params["sigma_net"], feat, prec)
    sigma = _TruncExp.apply(h[:, 0])
    hc = torch.cat([sh4(d), h[:, 1:], cfe], dim=-1)
    return sigma, torch.sigmoid(mlp(params["color_net"], hc, prec))
