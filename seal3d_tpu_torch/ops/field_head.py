"""The NGP field head: from the stacked encode of the density and colour
grids to (sigma, rgb), that is the density MLP, trunc_exp, the SH of the
view direction, the colour MLP and the sigmoid (models/ngp.py `apply`).

Replaces no Pallas kernel of the JAX package, which leaves this chain to
XLA. The hand-written kernel pair `field_head_fwd` / `field_head_bwd`
(csrc/field_head.cu) computes it in one launch each way, keeping every
activation on chip; its note says why and what bounds it.

`field_head` picks its path from what the inputs show, with no option:
- the kernel, for CUDA tensors at the widths it is built for (16 levels of
  two F=2 grids, hidden 64, density 32 -> 64 -> 16, colour 63 -> 64 -> 64
  -> 3, SH degree 4) when neither an MLP weight nor `d` needs a gradient.
  That is every forward of a frozen or no-grad field (renders, the Seal
  teacher's queries) and the Seal-3D local stage, which trains the tables
  alone. The backward gives the stacked encode's cotangent only;
- the plain composition otherwise (CPU tensors, training that moves the
  MLPs, other widths): `field_head_plain`, the same ops `apply` ran before
  the kernel, unchanged.
The kernel differs from the plain path only by fp32 summation order, and
with it the rare bf16 rounding of a hidden activation (the .cu's note).
"""

from __future__ import annotations

import torch

from seal3d_tpu_torch.ops.hashgrid import split_stacked
from seal3d_tpu_torch.ops.mlp import mlp_apply
from seal3d_tpu_torch.ops.sh import sh_encode
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp
from seal3d_tpu_torch.runtime.kernels import Kernel

# [in, out] of sigma_net's and color_net's layers, and [L, 2F] of the
# stacked encode, that the kernel is built for
KERNEL_WIDTHS = ((32, 64), (64, 16), (63, 64), (64, 64), (64, 3))
KERNEL_LEVELS = (16, 4)
KERNEL_SH_DEGREE = 4

# enc, d, the five weights, then sigma, rgb (forward) or g_sigma, g_rgb,
# g_enc (backward), M, stream
_FWD = Kernel("field_head_fwd", "ppppppppp l s")
_BWD = Kernel("field_head_bwd", "pppppppppp l s")


def field_head_plain(enc: torch.Tensor, d: torch.Tensor, sigma_net,
                     color_net, sh_degree: int):
    """enc [..., L, 2F] (the stacked encode: sigma grid's F, then the colour
    grid's), d [..., 3] unit dirs -> (sigma [...], rgb [..., 3])."""
    f = enc.shape[-1] // 2
    feat, c_enc = split_stacked(enc, (f, f))
    h = mlp_apply(sigma_net, feat)
    sigma = trunc_exp(h[..., 0])
    d_enc = sh_encode(d, sh_degree)
    hc = torch.cat([d_enc, h[..., 1:], c_enc], dim=-1)
    rgb = torch.sigmoid(mlp_apply(color_net, hc))
    return sigma, rgb


def _weights(sigma_net, color_net) -> list:
    return [layer["w"] for layer in list(sigma_net) + list(color_net)]


def kernel_takes(enc: torch.Tensor, d: torch.Tensor, sigma_net, color_net,
                 sh_degree: int) -> bool:
    """Whether `field_head` runs the kernel for these inputs: CUDA tensors
    and the rest of the rule (`_fits`)."""
    return enc.device.type == "cuda" and _fits(enc, d, sigma_net, color_net,
                                               sh_degree)


def _fits(enc: torch.Tensor, d: torch.Tensor, sigma_net, color_net,
          sh_degree: int) -> bool:
    """The rule but its device test: no gradient wanted but the encode's,
    and the kernel's widths, dtype and shapes."""
    ws = _weights(sigma_net, color_net)
    if sh_degree != KERNEL_SH_DEGREE:
        return False
    if torch.is_grad_enabled() and (d.requires_grad
                                    or any(w.requires_grad for w in ws)):
        return False
    return (tuple(tuple(w.shape) for w in ws) == KERNEL_WIDTHS
            and tuple(enc.shape[-2:]) == KERNEL_LEVELS
            and d.shape[-1] == 3 and d.shape[:-1] == enc.shape[:-2]
            and all(t.dtype == torch.float32 and t.device == enc.device
                    for t in [enc, d, *ws]))


def field_head(enc: torch.Tensor, d: torch.Tensor, sigma_net, color_net,
               sh_degree: int):
    """(sigma [...], rgb [..., 3]) of the stacked encode enc [..., L, 2F] and
    unit directions d [..., 3]: the kernel where `kernel_takes`, else
    `field_head_plain`. Differentiable in enc either way."""
    if not kernel_takes(enc, d, sigma_net, color_net, sh_degree):
        return field_head_plain(enc, d, sigma_net, color_net, sh_degree)
    batch = enc.shape[:-2]
    sigma, rgb = _FieldHead.apply(
        enc.reshape(-1, *KERNEL_LEVELS), d.reshape(-1, 3).contiguous(),
        *[w.contiguous() for w in _weights(sigma_net, color_net)])
    return sigma.reshape(batch), rgb.reshape(*batch, 3)


class _FieldHead(torch.autograd.Function):
    """The kernel pair; the gradient is enc's alone (`kernel_takes` sends
    everything else that needs one to the plain path)."""

    @staticmethod
    def forward(ctx, enc, d, *ws):
        enc = enc.contiguous()
        ctx.save_for_backward(enc, d, *ws)
        return field_head_fwd(enc, d, ws)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        enc, d, *ws = ctx.saved_tensors
        g_enc = field_head_bwd(enc, d, ws, g_sigma.contiguous(),
                               g_rgb.contiguous())
        return (g_enc, None) + (None,) * len(ws)


def field_head_fwd(enc, d, ws):
    """Kernel forward: enc [M, 16, 4], d [M, 3] contiguous f32 CUDA tensors,
    ws the five fp32 weights -> (sigma [M], rgb [M, 3]); counted in
    `field_head_fwd.launches`."""
    m = _check(enc, d, ws)
    sigma = torch.empty((m,), dtype=torch.float32, device=enc.device)
    rgb = torch.empty((m, 3), dtype=torch.float32, device=enc.device)
    if m:
        _FWD.launch(field_head_fwd, enc, d, *ws, sigma, rgb, m)
    return sigma, rgb


def field_head_bwd(enc, d, ws, g_sigma, g_rgb):
    """Kernel backward: the cotangent of enc [M, 16, 4] from those of sigma
    [M] and rgb [M, 3] (recomputing the forward); counted in
    `field_head_bwd.launches`."""
    m = _check(enc, d, ws)
    if (g_sigma.shape != (m,) or g_rgb.shape != (m, 3)
            or g_sigma.dtype != torch.float32
            or g_rgb.dtype != torch.float32):
        raise ValueError(f"field_head_bwd: cotangents must be f32 [{m}] and "
                         f"[{m}, 3]; got {g_sigma.dtype} "
                         f"{tuple(g_sigma.shape)}, {g_rgb.dtype} "
                         f"{tuple(g_rgb.shape)}")
    g_enc = torch.empty_like(enc)
    if m:
        _BWD.launch(field_head_bwd, enc, d, *ws, g_sigma, g_rgb, g_enc, m)
    return g_enc


field_head_fwd.launches = 0
field_head_bwd.launches = 0


def _check(enc, d, ws) -> int:
    m = enc.shape[0]
    tensors = [enc, d, *ws]
    if (enc.device.type != "cuda" or tuple(enc.shape[1:]) != KERNEL_LEVELS
            or tuple(d.shape) != (m, 3)
            or tuple(tuple(w.shape) for w in ws) != KERNEL_WIDTHS
            or any(t.dtype != torch.float32 or t.device != enc.device
                   or not t.is_contiguous() for t in tensors)
            or enc.data_ptr() % 16):
        got = [(t.dtype, tuple(t.shape), str(t.device)) for t in tensors]
        raise ValueError(
            "the field-head kernels need contiguous f32 CUDA tensors enc "
            f"[M, 16, 4] (16-byte aligned), d [M, 3] and weights "
            f"{KERNEL_WIDTHS}; got {got}")
    return m
