"""Geometry utilities for the editing layer (port of
seal3d_tpu/seal/geometry.py): self-contained numpy at config-build time
(PCA oriented bounding boxes, plane fit, the brush's voxel clustering and
kNN normals, OBJ / PLY export; copied from the reference, which needs no
JAX for them) and tensor code at render time (Moller-Trumbore ray/triangle test,
point-in-mesh, plane projection, point-to-triangle distance).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# 12 triangles of a box given its 8 corners ordered by (i&1, i>>1&1, i>>2&1).
_BOX_FACES = np.array([
    [0, 2, 1], [1, 2, 3],  # z-
    [4, 5, 6], [5, 7, 6],  # z+
    [0, 1, 4], [1, 5, 4],  # y-
    [2, 6, 3], [3, 6, 7],  # y+
    [0, 4, 2], [2, 4, 6],  # x-
    [1, 3, 5], [3, 7, 5],  # x+
], dtype=np.int32)


def plane_fit(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares plane: returns (unit normal, centroid)."""
    pts = np.asarray(points, np.float64)
    center = pts.mean(0)
    _, _, vt = np.linalg.svd(pts - center, full_matrices=False)
    normal = vt[-1]
    return normal.astype(np.float32), center.astype(np.float32)


def obb_from_points(points: np.ndarray):
    """PCA oriented bounding box.

    Returns dict(verts [8,3], faces [12,3], center [3], axes [3,3] (rows),
    half_extents [3]). Corner i is center + sum_d (+-half[d]) * axes[d] with
    sign from bit d of i.
    """
    pts = np.asarray(points, np.float64)
    center = pts.mean(0)
    if pts.shape[0] < 3:
        axes = np.eye(3)
    else:
        cov = np.cov((pts - center).T)
        _, vecs = np.linalg.eigh(cov + 1e-12 * np.eye(3))
        axes = vecs.T[::-1]  # rows, major first
    proj = (pts - center) @ axes.T
    lo, hi = proj.min(0), proj.max(0)
    mid_local = (lo + hi) / 2
    half = np.maximum((hi - lo) / 2, 1e-6)
    center = center + mid_local @ axes
    signs = np.array([[(i >> d) & 1 for d in range(3)] for i in range(8)]) * 2 - 1
    verts = center[None] + (signs * half[None]) @ axes
    return {
        "verts": verts.astype(np.float32),
        "faces": _BOX_FACES.copy(),
        "center": center.astype(np.float32),
        "axes": axes.astype(np.float32),
        "half_extents": half.astype(np.float32),
    }


def aabb_of(points: np.ndarray) -> np.ndarray:
    """[N,3] -> [2,3] (min, max)."""
    pts = np.asarray(points, np.float32)
    return np.stack([pts.min(0), pts.max(0)])


def box_mesh_from_aabb(bound: np.ndarray):
    lo, hi = np.asarray(bound[0]), np.asarray(bound[1])
    signs = np.array([[(i >> d) & 1 for d in range(3)] for i in range(8)])
    verts = np.where(signs == 1, hi[None], lo[None]).astype(np.float32)
    return verts, _BOX_FACES.copy()


def voxel_cluster_indices(points: np.ndarray,
                          simplify_voxel: int = 16) -> np.ndarray:
    """Indices of one representative point per occupied voxel; the voxel
    grid spans the cloud's AABB at `simplify_voxel` cells along its longest
    axis."""
    pts = np.asarray(points, np.float64)
    lo, hi = pts.min(0), pts.max(0)
    voxel = max(float((hi - lo).max()), 1e-6) / simplify_voxel
    keys = np.floor((pts - lo) / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return np.sort(idx)


def voxel_cluster_surface(points: np.ndarray, normal: np.ndarray,
                          growth=(-0.3, 1.0), simplify_voxel: int = 16):
    """The voxel-clustered representatives of a painted patch and the two
    sheets offset from them along `normal` by `growth` -> (reps [R, 3],
    sheet vertices [2R, 3]) f32. The sheets serve only the debug export;
    containment is evaluated parametrically (mappers._brush_contains)."""
    pts = np.asarray(points, np.float64)
    idx = voxel_cluster_indices(pts, simplify_voxel)
    reps = pts[idx]
    n = np.asarray(normal, np.float64)
    verts = np.concatenate([reps + n * growth[0], reps + n * growth[1]])
    return reps.astype(np.float32), verts.astype(np.float32)


def knn_point_normals(points: np.ndarray, k: int = 12,
                      orient: np.ndarray = None) -> np.ndarray:
    """Per-point normals [N, 3] f32 from the plane fit of each point's k
    nearest neighbours (itself included), flipped into the hemisphere of
    `orient` where given. O(N^2) over the stroke; neighbour ties break by
    numpy's argsort, as in the reference."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    k = min(k, n)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    nbr = np.argsort(d2, axis=1)[:, :k]
    normals = np.empty((n, 3), np.float32)
    for i in range(n):
        normals[i], _ = plane_fit(pts[nbr[i]])
    if orient is not None:
        flip = normals @ np.asarray(orient, np.float64) < 0
        normals[flip] *= -1
    return normals


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray = None):
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in np.asarray(faces):
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


def export_ply_points(path: str, points: np.ndarray, colors: np.ndarray = None):
    pts = np.asarray(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            line = f"{p[0]} {p[1]} {p[2]}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(np.uint8)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")


# --------------------------------------------------------------- tensor side

def moller_trumbore_any(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        tris: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """True where a ray hits any triangle (t >= 0). rays [N, 3], tris
    [F, 3, 3]. Every intermediate is a plain [N, F] tensor, as in the
    reference; degenerate triangles never intersect."""
    ax, ay, az = (tris[:, 0, i] for i in range(3))             # [F]
    e1x, e1y, e1z = (tris[:, 1, i] - tris[:, 0, i] for i in range(3))
    e2x, e2y, e2z = (tris[:, 2, i] - tris[:, 0, i] for i in range(3))
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    ox, oy, oz = (rays_o[:, i:i + 1] for i in range(3))        # [N, 1]
    dx, dy, dz = (rays_d[:, i:i + 1] for i in range(3))

    det = -(dx * nx[None] + dy * ny[None] + dz * nz[None])     # [N, F]
    invdet = 1.0 / (det + eps)
    a0x = ox - ax[None]
    a0y = oy - ay[None]
    a0z = oz - az[None]
    cx = a0y * dz - a0z * dy
    cy = a0z * dx - a0x * dz
    cz = a0x * dy - a0y * dx
    u = (cx * e2x[None] + cy * e2y[None] + cz * e2z[None]) * invdet
    v = -(cx * e1x[None] + cy * e1y[None] + cz * e1z[None]) * invdet
    t = (a0x * nx[None] + a0y * ny[None] + a0z * nz[None]) * invdet
    nondeg = (nx * nx + ny * ny + nz * nz) > 1e-16
    hit = (t >= 0) & (u >= 0) & (v >= 0) & (u + v <= 1.0) & nondeg[None, :]
    return hit.any(dim=1)


def points_in_mesh(points: torch.Tensor, tris: torch.Tensor,
                   test_dir: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inside test: a point is inside iff rays along +d and -d both hit the
    mesh."""
    if test_dir is None:
        test_dir = torch.tensor([0.4395064455, 0.617598629942, 0.652231566745],
                                dtype=points.dtype, device=points.device)
    test_dir = torch.broadcast_to(test_dir.reshape(-1, 3)[0], points.shape)
    return (moller_trumbore_any(points, test_dir, tris)
            & moller_trumbore_any(points, -test_dir, tris))


def project_points(plane_norm: torch.Tensor, plane_point: torch.Tensor,
                   points: torch.Tensor) -> torch.Tensor:
    """Project points onto the plane (normal, point)."""
    v = points - plane_point
    coef = (v @ plane_norm) / (plane_norm @ plane_norm).clamp(min=1e-12)
    return points - coef[..., None] * plane_norm


def point_triangle_distance(points: torch.Tensor,
                            tris: torch.Tensor) -> torch.Tensor:
    """Min distance from each point to any triangle. points [N, 3], tris
    [F, 3, 3] -> [N]."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    p = points[:, None, :]  # [N, 1, 3]
    ab = b - a
    ac = c - a
    ap = p - a[None]
    bp = p - b[None]
    cp = p - c[None]
    d1 = (ab[None] * ap).sum(-1)
    d2 = (ac[None] * ap).sum(-1)
    d3 = (ab[None] * bp).sum(-1)
    d4 = (ac[None] * bp).sum(-1)
    d5 = (ab[None] * cp).sum(-1)
    d6 = (ac[None] * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = (va + vb + vc).clamp(min=1e-12)
    v = vb / denom
    w = vc / denom
    # clamp to the triangle by region tests, in the reference's order
    for cond, vv, ww in (((d1 <= 0) & (d2 <= 0), 0.0, 0.0),
                         ((d3 >= 0) & (d4 <= d3), 1.0, 0.0),
                         ((d6 >= 0) & (d5 <= d6), 0.0, 1.0)):
        v = torch.where(cond, vv, v)
        w = torch.where(cond, ww, w)
    edge_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ab = (d1 / (d1 - d3).clamp(min=1e-12)).clamp(0, 1)
    v = torch.where(edge_ab, t_ab, v)
    w = torch.where(edge_ab, 0.0, w)
    edge_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_ac = (d2 / (d2 - d6).clamp(min=1e-12)).clamp(0, 1)
    v = torch.where(edge_ac, 0.0, v)
    w = torch.where(edge_ac, t_ac, w)
    edge_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    t_bc = ((d4 - d3) / ((d4 - d3) + (d5 - d6)).clamp(min=1e-12)).clamp(0, 1)
    v = torch.where(edge_bc, 1.0 - t_bc, v)
    w = torch.where(edge_bc, t_bc, w)
    v = v.clamp(0, 1)
    w = w.clamp(0, 1)
    closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
    d = torch.linalg.norm(p - closest, dim=-1)
    nondeg = (torch.linalg.cross(ab, ac) ** 2).sum(-1) > 1e-16
    d = torch.where(nondeg[None, :], d, torch.inf)
    return d.amin(dim=1)
