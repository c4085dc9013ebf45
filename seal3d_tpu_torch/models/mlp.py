"""Functional MLP (port of seal3d_tpu/models/mlp.py).

The reference runs every matmul with bf16 operands and fp32 accumulation
(`preferred_element_type=float32`) and returns fp32. The port reproduces that
by rounding inputs, weights and hidden activations to bf16 and multiplying
the rounded values in fp32: a product of two bf16 values is exact in fp32, so
only the summation order differs. (`torch.matmul` on bf16 tensors would
round its output to bf16 as well, which the reference does not.)
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


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """ReLU hidden layers, linear fp32 output."""
    h = _bf16(x)
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ _bf16(layer["w"])
        if i != n - 1:
            h = _bf16(torch.relu(h))
    return h
