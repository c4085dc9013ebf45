"""Plain reference of the Seal-3D local stage (Wang et al., ICCV 2023) on an
NGP student: the bbox and line-brush proxy mappers, the three point shells
with the frozen teacher's answers cached for them, and the pretraining
step (L1 on log1p sigma and on colour, Adam on the grid tables at a
constant rate, the 0.95 EMA over every leaf).

The mapper arithmetic and the shells' sampling (grids, direction sets,
numpy's default_rng(0) and (1) draws) are a frozen copy of the port's plain
code, since which points fall inside an edit depends on its exact rounding;
the teacher and the student are `ngp.field`. Nothing of the program is
imported.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ngp

_BOX_FACES = np.array([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6],
                       [0, 1, 4], [1, 5, 4], [2, 6, 3], [3, 6, 7],
                       [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]], np.int32)
_PAIR_ENTRIES = 2 ** 24


# ------------------------------------------------------------- host side

def plane_fit(points):
    pts = np.asarray(points, np.float64)
    center = pts.mean(0)
    normal = np.linalg.svd(pts - center, full_matrices=False)[2][-1]
    return normal.astype(np.float32), center.astype(np.float32)


def obb_from_points(points):
    pts = np.asarray(points, np.float64)
    center = pts.mean(0)
    if pts.shape[0] < 3:
        axes = np.eye(3)
    else:
        cov = np.cov((pts - center).T)
        axes = np.linalg.eigh(cov + 1e-12 * np.eye(3))[1].T[::-1]
    proj = (pts - center) @ axes.T
    lo, hi = proj.min(0), proj.max(0)
    half = np.maximum((hi - lo) / 2, 1e-6)
    center = center + ((lo + hi) / 2) @ axes
    signs = np.array([[(i >> d) & 1 for d in range(3)]
                      for i in range(8)]) * 2 - 1
    return (center[None] + (signs * half[None]) @ axes).astype(np.float32), \
        center.astype(np.float32)


def aabb_of(points):
    pts = np.asarray(points, np.float32)
    return np.stack([pts.min(0), pts.max(0)])


def voxel_cluster_indices(points, simplify_voxel=16):
    pts = np.asarray(points, np.float64)
    lo, hi = pts.min(0), pts.max(0)
    voxel = max(float((hi - lo).max()), 1e-6) / simplify_voxel
    keys = np.floor((pts - lo) / voxel).astype(np.int64)
    return np.sort(np.unique(keys, axis=0, return_index=True)[1])


def _hull_border(reps, normal, samples_per_edge=8):
    """Border samples of a line stroke: the 2-D convex hull of the
    representatives in the plane of `normal`, its edges resampled."""
    from scipy.spatial import ConvexHull

    n = normal / (np.linalg.norm(normal) + 1e-12)
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u) + 1e-12
    v = np.cross(n, u)
    origin = reps.mean(0)
    uv = (reps - origin) @ np.stack([u, v]).T
    try:
        hull = ConvexHull(uv).vertices
    except RuntimeError:
        hull = np.arange(len(uv))
    hp = np.concatenate([uv[hull], uv[hull][:1]])
    out = np.asarray([hp[i] * (1 - t) + hp[i + 1] * t for i in range(len(hull))
                      for t in np.linspace(0, 1, samples_per_edge,
                                           endpoint=False)], np.float32)
    return (origin[None] + out @ np.stack([u, v])).astype(np.float32)


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def build_mapper(config: dict, device) -> dict:
    """The edit of a seal.json config ('bbox', or 'brush' with line
    strokes and linear attenuation, no colour edit) -> {kind, fill_bound
    [B, 2, 3] numpy, tensors...}."""
    kind = config["type"]
    if kind == "bbox":
        raw = np.asarray(config["raw"], np.float32)
        transform = np.asarray(config["transform"], np.float32)
        scale = np.asarray(config["scale"], np.float32)
        verts, center = obb_from_points(raw)
        to_verts = (verts - center) * scale + center
        to_verts = (transform[:3, :3] @ to_verts.T).T + transform[:3, 3]
        to_aabb = aabb_of(to_verts)
        return {"kind": "bbox",
                "fill_bound": np.stack([to_aabb, aabb_of(verts)]),
                "map_bound": _f32(to_aabb[None], device),
                "triangles": _f32(to_verts[_BOX_FACES], device),
                "transform_inv": _f32(np.linalg.inv(transform), device),
                "rotation_inv": _f32(np.linalg.inv(transform[:3, :3]), device),
                "scale_inv": _f32(1.0 / scale, device),
                "center": _f32(center, device)}
    if kind != "brush" or config["brushType"] != "line" \
            or config["attenuationMode"] != "linear":
        raise NotImplementedError("the reference has bbox and line brushes")
    pts = np.asarray(config["raw"], np.float32)
    pressure, depth = float(config["brushPressure"]), float(config["brushDepth"])
    normal, center = plane_fit(pts)
    if "normal" in config and normal @ np.asarray(config["normal"]) < 0:
        normal = -normal
    ne = normal * pressure
    nt, ct = torch.from_numpy(normal), torch.from_numpy(center)
    proj = project_points(nt, ct, torch.from_numpy(pts)).numpy()
    reps = np.asarray(proj, np.float64)[voxel_cluster_indices(proj, 16)] \
        .astype(np.float32)
    bounds = aabb_of(np.concatenate([pts + 2 * ne, pts - depth * ne]))[None]
    span = reps.max(0) - reps.min(0)
    return {"kind": "brush", "fill_bound": bounds,
            "map_bound": _f32(bounds, device), "reps": _f32(reps, device),
            "pressure": _f32(pressure, device),
            "lateral_margin": _f32(1.5 * max(float(span.max()), 1e-4) / 16,
                                   device),
            "normal_expand": _f32(ne, device),
            "plane_center": _f32(center, device),
            "border_points": _f32(_hull_border(reps, ne), device),
            "attenuation_distance": _f32(float(config["attenuationDistance"]),
                                         device),
            "depth": _f32(depth, device)}


def sample_grid_points(bounds, step, angle_step, max_points=4_000_000):
    bounds = np.asarray(bounds, np.float32).reshape(-1, 2, 3)
    pts = []
    for lo, hi in bounds:
        counts = np.maximum(((hi - lo) / step).astype(np.int64), 1)
        while np.prod(counts) > max_points:
            counts = np.maximum(counts // 2, 1)
        axes = [np.linspace(lo[d], hi[d], int(counts[d])) for d in range(3)]
        pts.append(np.stack(np.meshgrid(*axes, indexing="ij"), -1)
                   .reshape(-1, 3))
    angles = np.deg2rad(np.arange(0.0, 360.0, angle_step))
    dirs = np.asarray([[np.cos(a) * np.sin(b), np.sin(a) * np.sin(b), np.cos(b)]
                       for a in angles for b in angles[: len(angles) // 2 + 1]],
                      np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12
    return np.concatenate(pts).astype(np.float32), dirs


# ----------------------------------------------------------- tensor side

def project_points(n, p0, points):
    coef = ((points - p0) @ n) / (n @ n).clamp(min=1e-12)
    return points - coef[..., None] * n


def _any_hit(ro, rd, tris, eps=1e-8):
    ax, ay, az = (tris[:, 0, i] for i in range(3))
    e1x, e1y, e1z = (tris[:, 1, i] - tris[:, 0, i] for i in range(3))
    e2x, e2y, e2z = (tris[:, 2, i] - tris[:, 0, i] for i in range(3))
    nx, ny, nz = e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z, \
        e1x * e2y - e1y * e2x
    ox, oy, oz = (ro[:, i:i + 1] for i in range(3))
    dx, dy, dz = (rd[:, i:i + 1] for i in range(3))
    invdet = 1.0 / (-(dx * nx[None] + dy * ny[None] + dz * nz[None]) + eps)
    a0x, a0y, a0z = ox - ax[None], oy - ay[None], oz - az[None]
    cx, cy, cz = a0y * dz - a0z * dy, a0z * dx - a0x * dz, a0x * dy - a0y * dx
    u = (cx * e2x[None] + cy * e2y[None] + cz * e2z[None]) * invdet
    v = -(cx * e1x[None] + cy * e1y[None] + cz * e1z[None]) * invdet
    t = (a0x * nx[None] + a0y * ny[None] + a0z * nz[None]) * invdet
    nondeg = (nx * nx + ny * ny + nz * nz) > 1e-16
    return ((t >= 0) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
            & nondeg[None, :]).any(dim=1)


def _in_bounds(bounds, points):
    return ((points[None] > bounds[:, None, 0])
            & (points[None] < bounds[:, None, 1])).all(-1).any(0)


def _nearest_d2(points, targets):
    rows = max(1, _PAIR_ENTRIES // max(targets.shape[0], 1))
    return torch.cat([((points[i:i + rows, None, :] - targets[None]) ** 2)
                      .sum(-1).amin(1)
                      for i in range(0, points.shape[0], rows)]
                     or [points.new_zeros((0,))])


def map_to_origin(m: dict, points, dirs):
    """(points mapped back to the source, dirs, in-edit mask)."""
    if m["kind"] == "bbox":
        d = (0.4395064455, 0.617598629942, 0.652231566745)
        td = torch.tensor(d, device=points.device).expand(points.shape)
        mask = (_in_bounds(m["map_bound"], points)
                & _any_hit(points, td, m["triangles"])
                & _any_hit(points, -td, m["triangles"]))
        homo = torch.cat([points, torch.ones_like(points[:, :1])], -1)
        t = (homo @ m["transform_inv"].T)[:, :3]
        origin = (t - m["center"]) * m["scale_inv"] + m["center"]
        return (torch.where(mask[:, None], origin, points),
                torch.where(mask[:, None], dirs @ m["rotation_inv"].T, dirs),
                mask)
    inb = _in_bounds(m["map_bound"], points)
    idx = torch.nonzero(inb)[:, 0]
    sub = points[idx]
    ne, pc = m["normal_expand"], m["plane_center"]
    ne_len = torch.linalg.norm(ne) + 1e-12
    h = (sub - pc) @ (ne / ne_len)
    ok_h = (h >= -m["depth"] * ne_len) & (h <= 2.0 * ne_len)
    proj = project_points(ne, pc, sub)
    sub_mask = ok_h & (torch.sqrt(_nearest_d2(proj, m["reps"]))
                       <= m["lateral_margin"])
    att = m["attenuation_distance"]
    bdist = torch.sqrt(_nearest_d2(proj, m["border_points"]))
    comp = ((att - bdist) / att.clamp(min=1e-12)).clamp(0.0, 1.0)
    mapped = sub - ne + comp[:, None] * ne
    mask = torch.zeros_like(inb)
    mask[idx] = sub_mask
    out = points.clone()
    out[idx] = torch.where(sub_mask[:, None], mapped, sub)
    return out, dirs, mask


# --------------------------------------------------------------- shells

def teacher_query(params, model, points, dirs, prec=ngp.STATED,
                  chunk=2 ** 18):
    with torch.no_grad():
        outs = [ngp.field(params, model, points[i:i + chunk],
                          dirs[i:i + chunk], prec=prec)
                for i in range(0, points.shape[0], chunk)]
    return (torch.cat([s for s, _ in outs]), torch.cat([c for _, c in outs]))


def shells(mapper: dict, teacher, model, pretrain: dict, device,
           prec=ngp.STATED) -> dict:
    """{shell: dict(points, dirs, sigma, color)} of the local, surrounding
    and global shells, the teacher's answers cached."""
    b = model["bound"]
    aabb = np.array([[-b] * 3, [b] * 3], np.float32)
    probe = torch.tensor([1.0, 0.0, 0.0], device=device)
    out = {}
    pts, dir_set = sample_grid_points(mapper["fill_bound"],
                                      pretrain["local_point_step"],
                                      pretrain["local_angle_step"])
    p = torch.from_numpy(pts).to(device)
    mpts, mdirs, mask = map_to_origin(mapper, p, probe.expand(p.shape))
    keep = torch.nonzero(mask)[:, 0]
    dirs_k = dir_set[np.random.default_rng(0).integers(0, len(dir_set),
                                                        int(keep.shape[0]))]
    sigma, color = teacher_query(teacher, model, mpts[keep], mdirs[keep], prec)
    out["local"] = dict(points=p[keep], dirs=torch.from_numpy(dirs_k).to(device),
                        sigma=sigma, color=color)
    sb = np.array(mapper["fill_bound"], np.float32).reshape(-1, 2, 3).copy()
    ext = pretrain["surrounding_bounds_extend"]
    sb[:, 0] = np.maximum(sb[:, 0] - ext, aabb[0])
    sb[:, 1] = np.minimum(sb[:, 1] + ext, aabb[1])
    for name, bounds, step in (("surrounding", sb,
                                pretrain["surrounding_point_step"]),
                               ("global", aabb[None],
                                pretrain["global_point_step"])):
        pts, dir_set = sample_grid_points(bounds, step,
                                          pretrain[f"{name}_angle_step"])
        p = torch.from_numpy(pts).to(device)
        keep = torch.nonzero(~map_to_origin(mapper, p,
                                            probe.expand(p.shape))[2])[:, 0]
        dirs_k = torch.from_numpy(dir_set[np.random.default_rng(1).integers(
            0, len(dir_set), int(keep.shape[0]))]).to(device)
        sigma, color = teacher_query(teacher, model, p[keep], dirs_k, prec)
        out[name] = dict(points=p[keep], dirs=dirs_k, sigma=sigma, color=color)
    return out


def batches(sh: dict, bs: int) -> list:
    """Every shell cut into batches of bs rows in shell order, the last of
    each padded with row 0 at weight 0."""
    out = []
    for v in sh.values():
        n = v["points"].shape[0]
        if n == 0:
            continue
        dev = v["points"].device
        pad = (-n) % bs
        idx = torch.cat([torch.arange(n, device=dev),
                         torch.zeros(pad, dtype=torch.int64, device=dev)])
        wgt = torch.cat([torch.ones(n, device=dev), torch.zeros(pad, device=dev)])
        for b in range((n + pad) // bs):
            r = idx[b * bs:(b + 1) * bs]
            out.append(dict(points=v["points"][r], dirs=v["dirs"][r],
                            sigma=v["sigma"][r], color=v["color"][r],
                            weight=wgt[b * bs:(b + 1) * bs]))
    return out


class RefPretrainer:
    """The student's pretraining steps: the grid tables move under Adam
    (b1 0.9, b2 0.99, eps 1e-15) at the constant rate `lr`, the MLPs stay
    frozen, the EMA (0.95) runs over every leaf."""

    def __init__(self, model, lr, params, prec=ngp.STATED, ema_decay=0.95):
        self.model, self.lr, self.prec, self.d = model, lr, prec, ema_decay
        self.params = {k: v.clone() for k, v in ngp.flatten(params).items()}
        self.ema = {k: v.clone() for k, v in self.params.items()}
        self.tree = params
        self.moved = [k for k in self.params if "encoder" in k.split("/")[0]]
        self.mu = {k: torch.zeros_like(self.params[k]) for k in self.moved}
        self.nu = {k: torch.zeros_like(self.params[k]) for k in self.moved}
        self.count = 0

    def loss(self, params, batch):
        sigma, color = ngp.field(params, self.model, batch["points"],
                                 batch["dirs"], prec=self.prec)
        w = batch["weight"]
        wsum = w.sum().clamp(min=1e-6)
        diff = (torch.log1p(sigma) - torch.log1p(batch["sigma"])).abs()
        return ((diff * w).sum() / wsum
                + ((color - batch["color"]).abs() * w[:, None]).sum()
                / (3 * wsum))

    def step(self, batch):
        """One batch -> (loss, gradient of the moved leaves)."""
        leaves = {k: self.params[k].detach().requires_grad_(True)
                  for k in self.moved}
        flat = {**self.params, **leaves}
        loss = self.loss(ngp.unflatten_like(self.tree, flat), batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            self.count += 1
            dev = loss.device
            cf = torch.tensor(float(self.count), device=dev)
            bc1 = 1 - torch.pow(torch.tensor(0.9, device=dev), cf)
            bc2 = 1 - torch.pow(torch.tensor(0.99, device=dev), cf)
            for k in self.moved:
                self.mu[k] = (1 - 0.9) * grads[k] + 0.9 * self.mu[k]
                self.nu[k] = (1 - 0.99) * (grads[k] * grads[k]) + 0.99 * self.nu[k]
                self.params[k] = self.params[k] - self.lr * (
                    (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-15))
            self.ema = {k: e * self.d + self.params[k] * (1.0 - self.d)
                        for k, e in self.ema.items()}
        return loss.detach(), grads
