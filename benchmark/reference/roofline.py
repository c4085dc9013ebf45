"""The yardstick's arithmetic: the card's published peaks, a kernel's least
time from its bytes and operations, the multiresolution encode's bytes and
operations from its shapes, and the NGP field's model FLOPs per sample.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit. The encode arithmetic follows the port's
chip-smoke `bound` / `encode_bound`: each input read once, each output
written once, and per (row, level) 8 corners x F multiply-adds plus ~30
operations of cell and weight arithmetic. Unlike `encode_bound` it leaves
the hash table out of the bytes: which of a 2^19-row level's rows a launch
reads (or, backward, scatters into) depends on the points, and a launch
over a small edit touches few of them, so only what every row must move
is counted and the least time stays a lower bound.
"""

from __future__ import annotations

from benchmark.reference.ngp import mlp_dims

PEAK_BYTES_S = 3.35e12      # HBM3
PEAK_FP32_S = 67e12         # fp32 outside the tensor cores
PEAK_BF16_S = 989e12        # bf16 tensor cores, fp32 accumulation


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take to move n_bytes (each input read
    once, each output written once) and do n_ops fp32 operations."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_FP32_S)


def encode_bytes_ops(rows: int, levels: int, f_dim: int) -> tuple[float, float]:
    """(bytes, operations) of one hash-grid encode launch over `rows`
    points, forward or backward alike: per row its position (12 B) and its
    [levels, F] fp32 features once (forward: written; backward: the
    cotangent read); the table's rows are not counted (see above)."""
    n_bytes = rows * 12 + 4 * f_dim * rows * levels
    return float(n_bytes), float(rows * levels * (16 * f_dim + 30))


def encode_least_seconds(rows: int, levels: int, f_dim: int) -> float:
    return least_seconds(*encode_bytes_ops(rows, levels, f_dim))


def mlp_flops(dims) -> int:
    """Forward FLOPs of one sample through a bias-free MLP with layer widths
    `dims` (2 per multiply-add)."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def ngp_field_flops(model: dict) -> dict:
    """The NGP field's forward-plus-backward FLOPs per sample, split by the
    peak they run at: {"mlp": the sigma and colour MLPs' products (bf16
    operands, fp32 accumulation; the backward is twice the forward: input
    and weight gradients), "fp32": the two grids' encodes (forward and
    backward, as encode_bytes_ops counts them) and the SH basis}."""
    levels, f = model["num_levels"], model["level_dim"]
    sigma, color = mlp_dims(model)
    mlp = 3 * (mlp_flops(sigma) + mlp_flops(color))
    # two grids of F each: forward and backward of the stacked encode
    encode = 2 * levels * (16 * (2 * f) + 30)
    sh = 60    # the degree-4 basis: ~40 products and sums, its backward none
    return {"mlp": float(mlp), "fp32": float(encode + sh)}


def ngp_pretrain_flops(model: dict) -> dict:
    """Per pretraining point: the field's forward, the MLPs' backward down to
    the grid features (input gradients only: the MLPs are frozen) and the
    grids' backward."""
    full = ngp_field_flops(model)
    # forward 1x, input-gradient backward 1x of the MLPs (no weight grads)
    return {"mlp": full["mlp"] * 2.0 / 3.0, "fp32": full["fp32"]}


def least_seconds_mixed(mlp_flops_total: float, fp32_ops_total: float) -> float:
    """The least time of a mix: the MLP products at the bf16 peak and the
    rest at the fp32 peak, one after the other."""
    return mlp_flops_total / PEAK_BF16_S + fp32_ops_total / PEAK_FP32_S
