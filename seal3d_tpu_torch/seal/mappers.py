"""Seal proxy-function mappers (port of seal3d_tpu/seal/mappers.py): the
bbox, brush (line and curve strokes) and anchor tools, with their colour
edits.

A mapper is a frozen config (kind, flags) plus a dict of precomputed
tensors. The three render-time operations:

    map_mask(mapper, points)              -> bool [N]
    map_to_origin(mapper, points, dirs)   -> (points', dirs', mask)
    map_color(mapper, points, dirs, rgb)  -> rgb'

Construction (host-side numpy, once per edit) mirrors the reference's:
  bbox   the OBB of the raw points; the target is the OBB scaled about its
         centre, then moved by the 4x4 transform; render-time queries inside
         the target are mapped back to the source, and with `mapSource` the
         vacated source space reads a given point instead.
  brush  a plane fit per stroke and a lift of `brushPressure` along its
         normal, attenuated linearly within `attenuationDistance` of the
         stroke's border (`linear`; `dry` marks the region and moves no
         point). Containment is parametric: the height along the normal and
         the lateral distance to the voxel-clustered stroke sheet; a `curve`
         stroke takes each representative's kNN normal instead of the
         plane's.
  anchor a cone of `radius` around the raw points' mean, stretched toward
         the translated anchor.
The bbox and anchor operations are elementwise tensor code with no host
sync. The brush's nearest-representative and border searches are [N, R]
differences: they run only on the rows inside the map bound (gathered, then
scattered back; every other row keeps its point and has mask False), in
blocks of rows that bound their memory. Every tool of the reference is
here; the GUI that draws them (`--gui`) is `seal3d_tpu_torch.gui`. The
config schema is the reference's `seal.json`, parsed with the standard
library: `//` comments and trailing commas of json5 files are stripped,
other json5 syntax is refused by the parser.
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
    kind: str                       # 'bbox' | 'brush' | 'anchor'
    data: Dict[str, torch.Tensor]   # device tensors
    # of {'hsv', 'rgb', 'image', 'map_source', 'dirs', 'curve'}
    flags: frozenset
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


def build_mapper(config: dict, workspace: Optional[str] = None,
                 device=None) -> SealMapper:
    kind = config["type"]
    if kind not in _BUILDERS:
        raise NotImplementedError(f"unknown seal tool type: {kind}")
    m = _BUILDERS[kind](config, workspace)
    _attach_color_edits(m, config)
    return m.to(device)


def mapper_from_jax(kind: str, data: Mapping[str, np.ndarray], flags,
                    device=None, **host) -> SealMapper:
    """The port's mapper from the pieces of a JAX package `SealMapper`: its
    `data` dict as numpy arrays, its flags, and its host-side fields
    (`force_fill_bound`, `map_bound`, `pose_center`, `pose_radius`,
    `config`, `attenuation_mode`) as keywords. Parity tests build the JAX
    mapper once and cross-load it with this."""
    if kind not in _BUILDERS:
        raise NotImplementedError(f"unknown seal tool type: {kind}")
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


def _build_brush(config: dict, workspace: Optional[str]) -> SealMapper:
    strokes = config["raw"]
    if np.asarray(strokes[0]).ndim == 1:
        strokes = [strokes]
    brush_type = config["brushType"]
    if isinstance(brush_type, str):
        brush_type = [brush_type] * len(strokes)
    pressure = float(config["brushPressure"])
    depth = float(config["brushDepth"])

    simplify_voxel = int(config.get("simplifyVoxel", 16))
    all_reps, all_rep_normals, bounds_list = [], [], []
    normal_expand = plane_center = None
    any_curve = False
    for pts, btype in zip(strokes, brush_type):
        pts = np.asarray(pts, np.float32)
        normal, center = geo.plane_fit(pts)
        if "normal" in config and normal @ np.asarray(config["normal"]) < 0:
            normal = -normal
        normal_expand = normal * pressure
        plane_center = center
        if btype == "curve":
            # the sheet follows the painted surface: kNN normals per point
            any_curve = True
            pt_normals = geo.knn_point_normals(pts, k=12, orient=normal)
            idx = geo.voxel_cluster_indices(pts, simplify_voxel)
            reps = pts[idx]
            all_rep_normals.append(pt_normals[idx])
            ext = np.concatenate([pts + 2 * pressure * pt_normals,
                                  pts - depth * pressure * pt_normals])
            if workspace:
                os.makedirs(workspace, exist_ok=True)
                sheet = np.concatenate(
                    [reps - depth * pressure * pt_normals[idx],
                     reps + 2 * pressure * pt_normals[idx]])
                geo.export_ply_points(os.path.join(workspace, "to.ply"), sheet)
        else:
            proj = geo.project_points(_f32(normal), _f32(center),
                                      _f32(pts)).numpy()
            reps, sheet_verts = geo.voxel_cluster_surface(
                proj, normal_expand, growth=(-depth, 2.0),
                simplify_voxel=simplify_voxel)
            all_rep_normals.append(np.tile(normal[None], (len(reps), 1)))
            ext = np.concatenate([pts + 2 * normal_expand,
                                  pts - depth * normal_expand])
            if workspace:
                os.makedirs(workspace, exist_ok=True)
                geo.export_ply_points(os.path.join(workspace, "to.ply"),
                                      sheet_verts)
        all_reps.append(reps)
        bounds_list.append(geo.aabb_of(ext))

    reps = np.concatenate(all_reps)
    rep_normals = np.concatenate(all_rep_normals)
    # lateral reach of the stroke: 1.5 cluster voxels
    span = reps.max(0) - reps.min(0)
    lateral_margin = 1.5 * max(float(span.max()), 1e-4) / simplify_voxel
    # border samples for the attenuation; a curve stroke keeps them at their
    # 3-D positions, so border distances follow the curved sheet
    border = _hull_border_points(reps, normal_expand, planar=not any_curve)

    bounds = np.stack(bounds_list)  # [B, 2, 3]
    data = {
        "map_bound": _f32(bounds),
        "reps": _f32(reps),
        "rep_normals": _f32(rep_normals),
        "pressure": _f32(pressure),
        "lateral_margin": _f32(lateral_margin),
        "normal_expand": _f32(normal_expand),
        "plane_center": _f32(plane_center),
        "border_points": _f32(border),
        "attenuation_distance": _f32(float(config["attenuationDistance"])),
        "depth": _f32(depth),
    }
    return SealMapper(
        kind="brush", data=data,
        flags=frozenset({"curve"} if any_curve else set()),
        attenuation_mode=config["attenuationMode"],
        force_fill_bound=bounds, map_bound=bounds,
        pose_center=reps.mean(0),
        pose_radius=float(np.linalg.norm(bounds[:, 1] - bounds[:, 0],
                                         axis=1).max() * 10),
        config=config,
    )


def _hull_border_points(reps: np.ndarray, normal: np.ndarray,
                        samples_per_edge: int = 8, planar: bool = True):
    """Stroke-border samples [S, 3] f32: the 2-D convex hull of the
    representatives in the plane of `normal`, its edges resampled. planar:
    points on that plane (line strokes); else the hull vertices keep their
    3-D positions and the edges run between them (curve strokes). Where
    qhull refuses the points (a collinear or too short stroke), every
    representative is taken as a hull vertex, as in the reference."""
    from scipy.spatial import ConvexHull

    n = normal / (np.linalg.norm(normal) + 1e-12)
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u) + 1e-12
    v = np.cross(n, u)
    origin = reps.mean(0)
    uv = (reps - origin) @ np.stack([u, v]).T  # [N, 2]
    try:
        hull_idx = ConvexHull(uv).vertices
    except RuntimeError:   # qhull's QhullError
        hull_idx = np.arange(len(uv))
    src = uv[hull_idx] if planar else reps[hull_idx]
    hp = np.concatenate([src, src[:1]])
    out = np.asarray([hp[i] * (1 - t) + hp[i + 1] * t
                      for i in range(len(src))
                      for t in np.linspace(0, 1, samples_per_edge,
                                           endpoint=False)], np.float32)
    if planar:
        out = origin[None] + out @ np.stack([u, v])
    return out.astype(np.float32)


def _build_anchor(config: dict, workspace: Optional[str]) -> SealMapper:
    raw = np.asarray(config["raw"], np.float32)
    v_translation = np.asarray(config["translation"], np.float32)
    v_anchor = raw.mean(0)
    radius = float(config["radius"])

    normal, plane_pt = geo.plane_fit(raw)
    v_translated = v_anchor + v_translation
    # the translated anchor projected onto the fitted plane
    proj = geo.project_points(_f32(normal), _f32(plane_pt),
                              _f32(v_translated[None])).numpy()[0]
    v_offset = proj - v_anchor
    v_h = proj - v_translated
    len_h = float(np.linalg.norm(v_h))

    # bounds: the OBB of a uv-sphere around the anchor and the translated tip
    theta = np.linspace(0, np.pi, 12)
    phi = np.linspace(0, 2 * np.pi, 24)
    tt, pp = np.meshgrid(theta, phi)
    sphere = 1.1 * radius * np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], -1
    ).reshape(-1, 3) + v_anchor
    cloud = np.vstack([sphere, v_anchor + 1.1 * v_translation,
                       sphere - 0.1 * v_translation])
    box = geo.obb_from_points(cloud)
    aabb = geo.aabb_of(box["verts"])
    if workspace:
        os.makedirs(workspace, exist_ok=True)
        geo.export_obj(os.path.join(workspace, "to.obj"), box["verts"],
                       box["faces"])

    data = {
        "map_bound": _f32(aabb[None]),
        "triangles": _f32(box["verts"][box["faces"]]),
        "v_anchor": _f32(v_anchor),
        "v_offset": _f32(v_offset),
        "v_h": _f32(v_h),
        "len_h": _f32(max(len_h, 1e-6)),
        "radius": _f32(radius),
        "scale": _f32(config.get("scale", [1.0, 1.0, 1.0])),
    }
    return SealMapper(
        kind="anchor", data=data, flags=frozenset({"map_source"}),
        force_fill_bound=aabb[None], map_bound=aabb[None],
        pose_center=box["center"],
        pose_radius=float(np.linalg.norm(v_translation) * 10 + 1e-3),
        config=config,
    )


_BUILDERS = {"bbox": _build_bbox, "brush": _build_brush,
             "anchor": _build_anchor}


# --------------------------------------------------------------- render-time

def _bound_mask(bounds: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[B, 2, 3] AABBs, [N, 3] -> [N] inside any."""
    inside = ((points[None] > bounds[:, None, 0])
              & (points[None] < bounds[:, None, 1]))
    return inside.all(-1).any(0)


def map_mask(mapper: SealMapper, points: torch.Tensor) -> torch.Tensor:
    """Edit-region membership: inside a map bound and inside the mesh (bbox,
    anchor) or the stroke (brush)."""
    d = mapper.data
    if mapper.kind == "brush":
        inb, idx, sub = _rows_in_bound(mapper, points)
        return _scatter_rows(torch.zeros_like(inb), idx,
                             _brush_contains(mapper, sub))
    m = _bound_mask(d["map_bound"], points)
    if "triangles" in d:
        return m & geo.points_in_mesh(points, d["triangles"])
    return m


# rows of an [N, R] difference computed at once: 2^24 entries (the [rows,
# R, 3] f32 difference is then 192 MiB)
_PAIR_ENTRIES = 2**24


def _rows_in_bound(mapper: SealMapper, points: torch.Tensor):
    """(in-bound mask [N], their row ids [n], their points [n, 3]): the rows
    a brush's [N, R] searches need (one host sync, for n)."""
    inb = _bound_mask(mapper.data["map_bound"], points)
    idx = torch.nonzero(inb)[:, 0]
    return inb, idx, points[idx]


def _scatter_rows(base: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """`base` with rows `idx` replaced by `rows`."""
    out = base.clone()
    out[idx] = rows
    return out


def _nearest_min(points: torch.Tensor, targets: torch.Tensor):
    """(min squared distance [N], argmin [N]) of each point to `targets`
    [R, 3], in the reference's difference form ((p - r)**2).sum(-1) (no
    matmul expansion, whose rounding could move an argmin on a near-tie;
    argmin takes the first minimum), in blocks of rows."""
    rows = max(1, _PAIR_ENTRIES // max(targets.shape[0], 1))
    mins, args = [], []
    for i in range(0, points.shape[0], rows):
        d2 = ((points[i:i + rows, None, :] - targets[None]) ** 2).sum(-1)
        m, a = d2.min(1)
        mins.append(m)
        args.append(a)
    if not mins:
        return points.new_zeros((0,)), torch.zeros(
            (0,), dtype=torch.int64, device=points.device)
    return torch.cat(mins), torch.cat(args)


def _nearest_rep_frame(mapper: SealMapper, points: torch.Tensor):
    """The nearest stroke representative's frame -> (h, lateral, n_near):
    the signed height above its local sheet, the in-sheet distance to it,
    and its normal."""
    d = mapper.data
    d2_min, j = _nearest_min(points, d["reps"])
    n_near = d["rep_normals"][j]
    h = ((points - d["reps"][j]) * n_near).sum(-1)
    lateral = torch.sqrt((d2_min - h * h).clamp(min=0.0))
    return h, lateral, n_near


def _curve_contains(d, h, lateral) -> torch.Tensor:
    p = d["pressure"]
    ok_h = (h >= -d["depth"] * p) & (h <= 2.0 * p)
    return ok_h & (lateral <= d["lateral_margin"])


def _brush_contains(mapper: SealMapper, points: torch.Tensor) -> torch.Tensor:
    """Parametric stroke containment: the height along the lifted normal
    within [-depth |ne|, 2 |ne|] and the lateral distance to the stroke
    sheet within the cluster margin. A curve stroke takes the nearest
    representative's normal."""
    d = mapper.data
    if "curve" in mapper.flags:
        h, lateral, _ = _nearest_rep_frame(mapper, points)
        return _curve_contains(d, h, lateral)
    ne = d["normal_expand"]
    ne_len = torch.linalg.norm(ne) + 1e-12
    h = (points - d["plane_center"]) @ (ne / ne_len)
    ok_h = (h >= -d["depth"] * ne_len) & (h <= 2.0 * ne_len)
    proj = geo.project_points(ne, d["plane_center"], points)
    lateral = torch.sqrt(_nearest_min(proj, d["reps"])[0])
    return ok_h & (lateral <= d["lateral_margin"])


def _brush_to_origin(mapper: SealMapper, points: torch.Tensor):
    """(mapped points, mask) of in-bound rows under a brush: pushed back
    along the normal by the pressure, less the linear attenuation within
    `attenuation_distance` of the stroke border."""
    d = mapper.data
    att = d["attenuation_distance"]
    if "curve" in mapper.flags:
        h, lateral, n_near = _nearest_rep_frame(mapper, points)
        mask = _curve_contains(d, h, lateral)
        bdist = torch.sqrt(_nearest_min(points, d["border_points"])[0])
        comp = ((att - bdist) / att.clamp(min=1e-12)).clamp(0.0, 1.0)
        mapped = points - (1.0 - comp)[:, None] * d["pressure"] * n_near
        return mapped, mask
    mask = _brush_contains(mapper, points)
    proj = geo.project_points(d["normal_expand"], d["plane_center"], points)
    bdist = torch.sqrt(_nearest_min(proj, d["border_points"])[0])
    comp = ((att - bdist) / att.clamp(min=1e-12)).clamp(0.0, 1.0)
    mapped = points - d["normal_expand"] + comp[:, None] * d["normal_expand"]
    return mapped, mask


def map_to_origin(mapper: SealMapper, points: torch.Tensor,
                  dirs: Optional[torch.Tensor] = None):
    """Remap query points (and, for bbox, their dirs) back to source space
    -> (points', dirs', mask)."""
    d = mapper.data
    if mapper.kind == "bbox":
        mask = map_mask(mapper, points)
        homo = torch.cat([points, torch.ones_like(points[:, :1])], -1)
        transformed = (homo @ d["transform_inv"].T)[:, :3]
        origin = (transformed - d["center"]) * d["scale_inv"] + d["center"]
        base = points
        if "map_source" in mapper.flags:
            src = (points > d["empty_bound"][0]) & (points < d["empty_bound"][1])
            base = torch.where(src.all(-1)[:, None], d["map_source_point"],
                               base)
        out_pts = torch.where(mask[:, None], origin, base)
        out_dirs = dirs
        if dirs is not None:
            out_dirs = torch.where(mask[:, None], dirs @ d["rotation_inv"].T,
                                   dirs)
        return out_pts, out_dirs, mask

    if mapper.kind == "brush":
        inb, idx, sub = _rows_in_bound(mapper, points)
        if mapper.attenuation_mode == "dry":
            sub_mask = _brush_contains(mapper, sub)
            return points, dirs, _scatter_rows(torch.zeros_like(inb), idx,
                                               sub_mask)
        mapped, sub_mask = _brush_to_origin(mapper, sub)
        mask = _scatter_rows(torch.zeros_like(inb), idx, sub_mask)
        out = _scatter_rows(points, idx,
                            torch.where(sub_mask[:, None], mapped, sub))
        return out, dirs, mask

    if mapper.kind == "anchor":
        proj = geo.project_points(d["v_h"], d["v_anchor"], points)
        v_to_plane = proj - points
        plane_dist = torch.linalg.norm(v_to_plane, dim=-1)
        proj_off = proj - (plane_dist[:, None] / d["len_h"]) * d["v_offset"]
        pop_anchor = torch.linalg.norm(proj_off - d["v_anchor"], dim=-1)
        in_cone = (pop_anchor <= d["radius"]) & (
            plane_dist / (d["radius"] - pop_anchor).clamp(min=1e-12)
            < d["len_h"] / d["radius"] * 1.1)
        valid_side = (v_to_plane @ d["v_h"]) > 0
        mask = in_cone & valid_side & _bound_mask(d["map_bound"], points)
        v_map = -((d["len_h"] - plane_dist) / 10.0)[:, None] * d["v_h"] \
            / d["len_h"]
        mapped = (proj_off - v_map - d["v_anchor"]) * d["scale"] + d["v_anchor"]
        return torch.where(mask[:, None], mapped, points), dirs, mask

    raise NotImplementedError(f"unknown seal tool type: {mapper.kind}")


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
