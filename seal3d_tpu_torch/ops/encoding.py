"""Encoder factory (port of seal3d_tpu/ops/encoding.py `get_encoder`): a
name maps to an `Encoder` record, `init(generator, device) -> params |
None`, `encode(params, x) -> features` and `output_dim`. Parameter-free
encoders ('none', 'frequency', 'sphere_harmonics') return params None and
ignore them in encode.

Names as in the JAX package (case-insensitive): 'none' | 'identity',
'frequency' | 'freq', 'sphere_harmonics' | 'spherical_harmonics' | 'sh',
'hashgrid', 'tiledgrid', 'wrapgrid'; 'ash' raises NotImplementedError, as
there. Extra keyword arguments pass through to HashGridConfig.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from seal3d_tpu_torch.ops.freq import freq_encode, freq_encode_dim
from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, hashgrid_encode,
                                           hashgrid_init)
from seal3d_tpu_torch.ops.sh import sh_encode, sh_encode_dim


@dataclass(frozen=True)
class Encoder:
    name: str
    output_dim: int
    # (generator, device) -> params, or None for a parameter-free encoder
    init: Callable[[Optional[torch.Generator], Any], Any]
    encode: Callable[[Any, torch.Tensor], torch.Tensor]
    grid_cfg: Optional[HashGridConfig] = None


def _no_params(generator=None, device=None):
    return None


def get_encoder(name: str, input_dim: int = 3, *, multires: int = 6,
                degree: int = 4, num_levels: int = 16, level_dim: int = 2,
                base_resolution: int = 16, log2_hashmap_size: int = 19,
                desired_resolution: int = 2048, backend: str = "xla",
                align_corners: bool = False, **grid_kwargs) -> Encoder:
    """Build an encoder by name (multires: frequency octaves; degree: SH
    degree; the rest configure a grid)."""
    key = name.lower()
    if key in ("none", "identity"):
        return Encoder(name="none", output_dim=input_dim, init=_no_params,
                       encode=lambda p, x: x)
    if key in ("frequency", "freq"):
        return Encoder(name="frequency",
                       output_dim=freq_encode_dim(input_dim, multires),
                       init=_no_params,
                       encode=lambda p, x: freq_encode(x, multires))
    if key in ("sphere_harmonics", "spherical_harmonics", "sh"):
        if input_dim != 3:
            raise ValueError("SH encodes unit 3-D directions")
        return Encoder(name="sphere_harmonics",
                       output_dim=sh_encode_dim(degree), init=_no_params,
                       encode=lambda p, x: sh_encode(x, degree))
    if key in ("hashgrid", "tiledgrid", "wrapgrid"):
        gridtype = {"hashgrid": "hash", "tiledgrid": "tiled",
                    "wrapgrid": "wrap"}[key]
        cfg = HashGridConfig(
            num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution, gridtype=gridtype,
            input_dim=input_dim, backend=backend,
            align_corners=align_corners, **grid_kwargs)
        return Encoder(
            name=key, output_dim=cfg.output_dim,
            init=lambda generator=None, device=None: hashgrid_init(
                cfg, generator=generator, device=device),
            encode=lambda p, x: hashgrid_encode(p, x, cfg), grid_cfg=cfg)
    if key == "ash":
        raise NotImplementedError(
            "'ash' is not implemented by the reference either")
    raise ValueError(f"unknown encoder '{name}'")
