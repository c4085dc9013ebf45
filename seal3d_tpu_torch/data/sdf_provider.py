"""SDF training data: online point sampling against a mesh (port of
seal3d_tpu/data/sdf_provider.py). Per batch, half the points are
near-surface (area-weighted triangle samples plus N(0, 0.01) jitter) and
half uniform in [-1, 1]^3; all are drawn by a numpy generator seeded like
the reference's, so both packages get the same points from one seed. The
signed distance is the port's point-triangle distance, negative where the
inside test (seal/geometry.py) says inside. The mesh loads from ascii OBJ or
PLY."""

from __future__ import annotations

import numpy as np
import torch

from seal3d_tpu_torch.seal.geometry import (point_triangle_distance,
                                            points_in_mesh)

# (point, face) pairs a signed-distance call holds at once: its [points,
# faces] temporaries stay near 1 GiB whatever the mesh
CHUNK_PAIRS = 2**24


def load_mesh(path: str):
    """Minimal ascii OBJ/PLY loader -> (verts [V, 3] f32, faces [F, 3] i32)."""
    verts, faces = [], []
    if path.endswith(".obj"):
        with open(path) as f:
            for line in f:
                p = line.split()
                if not p:
                    continue
                if p[0] == "v":
                    verts.append([float(p[1]), float(p[2]), float(p[3])])
                elif p[0] == "f":
                    faces.append([int(t.split("/")[0]) - 1 for t in p[1:4]])
    else:
        with open(path) as f:
            n_v = n_f = 0
            for line in f:
                if line.startswith("element vertex"):
                    n_v = int(line.split()[-1])
                elif line.startswith("element face"):
                    n_f = int(line.split()[-1])
                elif line.startswith("end_header"):
                    break
            for _ in range(n_v):
                verts.append([float(t) for t in f.readline().split()[:3]])
            for _ in range(n_f):
                p = f.readline().split()
                faces.append([int(p[1]), int(p[2]), int(p[3])])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


class SDFDataset:
    """Online sampler over a mesh normalized into [-scale, scale]^3; the
    signed distances are computed on `device` (the card unless 'cpu' is
    given)."""

    def __init__(self, mesh_path: str = None, verts: np.ndarray = None,
                 faces: np.ndarray = None, scale: float = 0.8, seed: int = 0,
                 device=None):
        if mesh_path is not None:
            verts, faces = load_mesh(mesh_path)
        v = np.asarray(verts, np.float32)
        center = (v.max(0) + v.min(0)) / 2
        extent = (v.max(0) - v.min(0)).max() / 2
        self.verts = (v - center) / max(extent, 1e-9) * scale
        self.faces = np.asarray(faces, np.int32)
        self.device = torch.device(device if device is not None else "cuda")
        self.tris = torch.from_numpy(self.verts[self.faces]).to(self.device)
        a, b, c = (self.verts[self.faces[:, i]] for i in range(3))
        self.areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        self.areas = self.areas / max(self.areas.sum(), 1e-12)
        self.rng = np.random.default_rng(seed)
        self.chunk = max(CHUNK_PAIRS // max(len(self.faces), 1), 1)

    @torch.no_grad()
    def sdf(self, pts: torch.Tensor) -> torch.Tensor:
        """Signed distance [n] of points [n, 3] on the dataset's device."""
        out = []
        for i in range(0, pts.shape[0], self.chunk):
            p = pts[i:i + self.chunk]
            d = point_triangle_distance(p, self.tris)
            out.append(torch.where(points_in_mesh(p, self.tris), -d, d))
        return torch.cat(out)

    def sample_surface(self, n: int) -> np.ndarray:
        fi = self.rng.choice(len(self.faces), n, p=self.areas)
        u = self.rng.uniform(size=(n, 2)).astype(np.float32)
        flip = u.sum(-1) > 1
        u[flip] = 1 - u[flip]
        a, b, c = (self.verts[self.faces[fi, i]] for i in range(3))
        return a + u[:, :1] * (b - a) + u[:, 1:2] * (c - a)

    def batch(self, n: int):
        """(points [n, 3] f32, sdf [n] f32) tensors on the device: n/2
        near-surface, then n - n/2 uniform."""
        ns = n // 2
        surf = self.sample_surface(ns)
        surf = surf + self.rng.normal(scale=0.01, size=surf.shape).astype(
            np.float32)
        uni = self.rng.uniform(-1, 1, size=(n - ns, 3)).astype(np.float32)
        pts = torch.from_numpy(np.concatenate([surf, uni]).astype(
            np.float32)).to(self.device)
        return pts, self.sdf(pts)
