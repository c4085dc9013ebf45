"""Seal proxy-function mappers (port of seal3d_tpu/seal/mappers.py): the
bbox tool with its colour edits.

A mapper is a frozen config (kind, flags) plus a dict of precomputed
tensors. The three render-time operations are vectorized tensor code with
no boolean indexing and no host sync:

    map_mask(mapper, points)              -> bool [N]
    map_to_origin(mapper, points, dirs)   -> (points', dirs', mask)
    map_color(mapper, points, dirs, rgb)  -> rgb'

Construction (host-side numpy, once per edit) mirrors the reference's: the
OBB of the raw points; the target is the OBB scaled about its centre, then
moved by the 4x4 transform; render-time queries inside the target are
mapped back to the source, and with `mapSource` the vacated source space
reads a given point instead. The brush, curve and anchor tools are not
ported yet and raise NotImplementedError. The config schema is the
reference's `seal.json`, parsed with the standard library: `//` comments
and trailing commas of json5 files are stripped, other json5 syntax is
refused by the parser.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from seal3d_tpu_torch.seal import geometry as geo
from seal3d_tpu_torch.seal.color import modify_hsv, modify_rgb


@dataclass
class SealMapper:
    kind: str                       # 'bbox'
    data: Dict[str, torch.Tensor]   # device tensors
    flags: frozenset                # of {'hsv', 'rgb', 'image', 'map_source', 'dirs'}
    attenuation_mode: str = "linear"
    # host-side copies for the trainer, the bitfield hack and pose sampling
    force_fill_bound: np.ndarray = None   # [B, 2, 3]
    map_bound: np.ndarray = None          # [B, 2, 3]
    pose_center: np.ndarray = None
    pose_radius: float = 1.0
    config: dict = field(default_factory=dict)

    def to(self, device) -> "SealMapper":
        """This mapper with its tensors on `device`."""
        self.data = {k: v.to(device) for k, v in self.data.items()}
        return self


_JSON5_COMMENT = re.compile(r'("(?:\\.|[^"\\])*")|//[^\n]*|/\*.*?\*/', re.S)
_TRAILING_COMMA = re.compile(r",(\s*[}\]])")


def load_mapper_config(config_path: str,
                       config_file: str = "seal.json") -> dict:
    """Parse a seal.json edit config with the standard library; comments and
    trailing commas (the json5 the reference's files use) are stripped."""
    with open(os.path.join(config_path, config_file)) as f:
        text = f.read()
    text = _JSON5_COMMENT.sub(lambda m: m.group(1) or "", text)
    return json.loads(_TRAILING_COMMA.sub(r"\1", text))


def _not_ported(tool: str):
    return NotImplementedError(
        f"the Seal {tool} is not ported yet: ROADMAP.md Queue 1, 'Seal "
        f"editing: what stays'")


def build_mapper(config: dict, workspace: Optional[str] = None,
                 device=None) -> SealMapper:
    kind = config["type"]
    if kind == "bbox":
        m = _build_bbox(config, workspace)
    elif kind in ("brush", "anchor"):
        raise _not_ported(f"{kind} tool")
    else:
        raise NotImplementedError(f"unknown seal tool type: {kind}")
    _attach_color_edits(m, config)
    return m.to(device)


def mapper_from_jax(kind: str, data: Mapping[str, np.ndarray], flags,
                    device=None, **host) -> SealMapper:
    """The port's mapper from the pieces of a JAX package `SealMapper`: its
    `data` dict as numpy arrays, its flags, and its host-side fields
    (`force_fill_bound`, `map_bound`, `pose_center`, `pose_radius`,
    `config`, `attenuation_mode`) as keywords. Parity tests build the JAX
    mapper once and cross-load it with this."""
    if kind != "bbox":
        raise _not_ported(f"{kind} tool")
    tensors = {k: torch.from_numpy(np.array(v)).to(device)
               for k, v in data.items()}
    return SealMapper(kind=kind, data=tensors, flags=frozenset(flags), **host)


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _attach_color_edits(m: SealMapper, config: dict):
    flags = set(m.flags)
    if "hsv" in config:
        m.data["hsv"] = _f32(config["hsv"])
        flags.add("hsv")
    if "rgb" in config:
        m.data["rgb"] = _f32(config["rgb"])
        m.data["rgb_light_offset"] = _f32(config.get("rgbLightOffset", 0.0))
        flags.add("rgb")
    if "imageConfig" in config:
        ic = config["imageConfig"]
        import cv2

        raw = cv2.imread(ic["path"], cv2.IMREAD_UNCHANGED)
        if raw is None:
            raise FileNotFoundError(ic["path"])
        if raw.ndim == 3 and raw.shape[2] == 4:
            alpha = raw[:, :, 3].astype(np.float32) / 255.0
        else:
            alpha = np.ones(raw.shape[:2], np.float32)
        img = raw[:, :, [2, 1, 0]].astype(np.float32) / 255.0
        v_o = np.asarray(ic["o"], np.float32)
        v_w = np.asarray(ic["w"], np.float32)
        v_h = np.asarray(ic["h"], np.float32)
        normal, _ = geo.plane_fit(np.stack([v_o, v_w, v_h]))
        m.data.update(image=_f32(img), image_mask=_f32(alpha),
                      v_image_norm=_f32(normal), v_image_o=_f32(v_o),
                      v_image_w=_f32(v_w), v_image_h=_f32(v_h),
                      rgb_light_offset=_f32(config.get("rgbLightOffset", 0.0)))
        flags.add("image")
    m.flags = frozenset(flags)


def _build_bbox(config: dict, workspace: Optional[str]) -> SealMapper:
    raw = np.asarray(config["raw"], np.float32)
    transform = np.asarray(config["transform"], np.float32)
    scale = np.asarray(config["scale"], np.float32)

    from_box = geo.obb_from_points(raw)
    from_center = from_box["center"]
    to_verts = (from_box["verts"] - from_center) * scale + from_center
    to_verts = (transform[:3, :3] @ to_verts.T).T + transform[:3, 3]
    to_center = to_verts.mean(0)

    if workspace:
        os.makedirs(workspace, exist_ok=True)
        geo.export_obj(os.path.join(workspace, "from.obj"), from_box["verts"],
                       from_box["faces"])
        geo.export_obj(os.path.join(workspace, "to.obj"), to_verts,
                       from_box["faces"])

    bound_type = config.get("boundType", "to")
    from_aabb = geo.aabb_of(from_box["verts"])
    to_aabb = geo.aabb_of(to_verts)
    fill_bounds = np.stack([to_aabb, from_aabb])  # [2, 2, 3]

    if bound_type == "to":
        bounds = to_aabb[None]
        tris = to_verts[from_box["faces"]]
    elif bound_type == "from":
        bounds = from_aabb[None]
        tris = from_box["verts"][from_box["faces"]]
    else:  # both
        bounds = fill_bounds
        tris = np.concatenate([to_verts[from_box["faces"]],
                               from_box["verts"][from_box["faces"]]])

    data = {
        "map_bound": _f32(bounds),
        "triangles": _f32(tris),
        "transform_inv": _f32(np.linalg.inv(transform)),
        "rotation_inv": _f32(np.linalg.inv(transform[:3, :3])),
        "scale_inv": _f32(1.0 / scale),
        "center": _f32(from_center),
    }
    flags = {"dirs"}
    if config.get("mapSource"):
        data["empty_bound"] = _f32(from_aabb)
        data["map_source_point"] = _f32(config["mapSource"])
        flags.add("map_source")

    return SealMapper(
        kind="bbox", data=data, flags=frozenset(flags),
        force_fill_bound=fill_bounds, map_bound=bounds,
        pose_center=(from_center + to_center) / 2,
        pose_radius=float(np.linalg.norm(from_center - to_center) * 10 + 1e-3),
        config=config,
    )


# --------------------------------------------------------------- render-time

def _bound_mask(bounds: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[B, 2, 3] AABBs, [N, 3] -> [N] inside any."""
    inside = ((points[None] > bounds[:, None, 0])
              & (points[None] < bounds[:, None, 1]))
    return inside.all(-1).any(0)


def map_mask(mapper: SealMapper, points: torch.Tensor) -> torch.Tensor:
    """Edit-region membership: inside a map bound and inside the mesh."""
    d = mapper.data
    m = _bound_mask(d["map_bound"], points)
    if "triangles" in d:
        return m & geo.points_in_mesh(points, d["triangles"])
    return m


def map_to_origin(mapper: SealMapper, points: torch.Tensor,
                  dirs: Optional[torch.Tensor] = None):
    """Remap query points (and their dirs) back to source space ->
    (points', dirs', mask)."""
    if mapper.kind != "bbox":
        raise _not_ported(f"{mapper.kind} tool")
    d = mapper.data
    mask = map_mask(mapper, points)
    homo = torch.cat([points, torch.ones_like(points[:, :1])], -1)
    transformed = (homo @ d["transform_inv"].T)[:, :3]
    origin = (transformed - d["center"]) * d["scale_inv"] + d["center"]
    base = points
    if "map_source" in mapper.flags:
        src = (points > d["empty_bound"][0]) & (points < d["empty_bound"][1])
        base = torch.where(src.all(-1)[:, None], d["map_source_point"], base)
    out_pts = torch.where(mask[:, None], origin, base)
    out_dirs = dirs
    if dirs is not None:
        out_dirs = torch.where(mask[:, None], dirs @ d["rotation_inv"].T, dirs)
    return out_pts, out_dirs, mask


def map_color(mapper: SealMapper, points: torch.Tensor, dirs, colors,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Colour / texture modification of edit-region samples. `mask` marks
    the edit-region samples so batch statistics (modify_rgb's V mean)
    ignore the others."""
    d = mapper.data
    out = colors
    if "hsv" in mapper.flags:
        out = modify_hsv(out, d["hsv"])
    if "rgb" in mapper.flags:
        out = modify_rgb(out, d["rgb"], d["rgb_light_offset"], mask=mask)
    if "image" in mapper.flags:
        img = d["image"]
        hh, ww = img.shape[0], img.shape[1]
        proj = geo.project_points(d["v_image_norm"], d["v_image_o"], points)
        v_op = proj - d["v_image_o"]
        v_ow = d["v_image_w"] - d["v_image_o"]
        v_oh = d["v_image_h"] - d["v_image_o"]
        iw = torch.floor((v_op @ v_ow) / (v_ow @ v_ow).clamp(min=1e-12) * ww) \
            .clamp(0, ww - 1).to(torch.int64)
        ih = torch.floor((v_op @ v_oh) / (v_oh @ v_oh).clamp(min=1e-12) * hh) \
            .clamp(0, hh - 1).to(torch.int64)
        alpha = d["image_mask"][ih, iw][:, None]
        textured = modify_rgb(out, img[ih, iw], d["rgb_light_offset"],
                              mask=mask)
        out = alpha * textured + (1 - alpha) * out
    return out
