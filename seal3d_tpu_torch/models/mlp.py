"""Functional MLP (port of seal3d_tpu/models/mlp.py).

The reference runs every matmul with bf16 operands and fp32 accumulation
(`preferred_element_type=float32`) and returns fp32. The port reproduces that
by rounding inputs, weights and hidden activations to bf16 and multiplying
the rounded values in fp32: a product of two bf16 values is exact in fp32, so
only the summation order differs. (`torch.matmul` on bf16 tensors would
round its output to bf16 as well, which the reference does not.) The casts'
backwards round the cotangents to bf16 too, as the reference's do. Under a
data mesh the reference rounds each use's weight cotangent after the
partitioned step's sum over 'data'; here too (`_Bf16Weight`), so n ranks
give the one process's weight gradients up to summation order, also for a
weight used twice in a step (D-NeRF's regularisers), which a single
rounding after the trainer's sum would not.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def mlp_init(dims: Sequence[int], generator: Optional[torch.Generator] = None,
             device=None):
    """Bias-free Kaiming-uniform [din, dout] weights (torch.nn.Linear's
    default bound), as a list of {"w": ...} layers like the reference."""
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(din)
        w = torch.rand((din, dout), generator=generator, dtype=torch.float32,
                       device=device) * (2.0 * bound) - bound
        params.append({"w": w})
    return params


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class _Bf16Weight(torch.autograd.Function):
    """A weight rounded to bf16, whose cotangent is summed over the mesh's
    'data' axis before it is rounded: the backward returns bf16(sum) / n,
    this use's gradient of the global batch's loss (each rank's loss is the
    mean over its equal slice), which the trainer's reduce_step leaves
    as it is."""

    @staticmethod
    def forward(ctx, w, mesh):
        ctx.mesh = mesh
        return _bf16(w)

    @staticmethod
    def backward(ctx, g):
        from seal3d_tpu_torch.parallel.mesh import collective

        s = collective("all_reduce", g.contiguous().clone(), ctx.mesh,
                       "data", "mlp_grads")
        return _bf16(s) / ctx.mesh.size("data"), None


def _bf16_weight(w: torch.Tensor) -> torch.Tensor:
    from seal3d_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None or mesh.size("data") == 1 or not w.requires_grad:
        return _bf16(w)
    return _Bf16Weight.apply(w, mesh)


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """ReLU hidden layers, linear fp32 output."""
    h = _bf16(x)
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ _bf16_weight(layer["w"])
        if i != n - 1:
            h = _bf16(torch.relu(h))
    return h
