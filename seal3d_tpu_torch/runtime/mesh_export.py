"""Mesh extraction and export (port of seal3d_tpu/runtime/mesh_export.py):
the density field queried on a dense lattice in fixed-size chunks on its
device, the iso-surface extracted by the C++ marching tetrahedra
(csrc/mesh_extract.cpp, built with g++ at first use), written as PLY or
OBJ."""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from seal3d_tpu_torch.runtime.build import load_host_library


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def marching_tetrahedra(grid: np.ndarray, iso: float, origin, spacing):
    """grid [nz, ny, nx] f32 -> (verts [V, 3] f32, tris [T, 3] i32) in world
    coordinates: vertex (x, y, z) of lattice node (i, j, k) is origin +
    spacing * (k, j, i)."""
    fn = load_host_library("mesh_extract").marching_tetrahedra
    fn.restype = ctypes.c_int
    grid = np.ascontiguousarray(grid, np.float32)
    nz, ny, nx = grid.shape
    max_v = max(int(grid.size // 2), 1 << 16)
    max_t = max_v * 2
    out_v = np.empty((max_v, 3), np.float32)
    out_t = np.empty((max_t, 3), np.int32)
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    origin = np.asarray(origin, np.float32)
    spacing = np.asarray(spacing, np.float32)
    truncated = fn(_ptr(grid, ctypes.c_float), ctypes.c_int(nx),
                   ctypes.c_int(ny), ctypes.c_int(nz), ctypes.c_float(iso),
                   _ptr(origin, ctypes.c_float), _ptr(spacing, ctypes.c_float),
                   _ptr(out_v, ctypes.c_float), ctypes.c_int64(max_v),
                   _ptr(out_t, ctypes.c_int32), ctypes.c_int64(max_t),
                   ctypes.byref(nv), ctypes.byref(nt))
    if truncated:
        print("[mesh_export] warning: mesh truncated at its vertex or "
              "triangle budget")
    return out_v[: nv.value].copy(), out_t[: nt.value].copy()


@torch.no_grad()
def extract_geometry(density_fn, bound: float, resolution: int = 256,
                     threshold: float = 10.0, chunk: int = 2**16,
                     device=None):
    """Sample density_fn ([M, 3] -> [M] sigma) on the [z, y, x] lattice of
    `resolution`^3 points over [-bound, bound]^3 in chunks of `chunk`
    points (the last one padded with the origin), each built and queried on
    `device` (the card unless 'cpu' is given), then extract its iso-surface
    at `threshold` -> (verts [V, 3], tris [T, 3]) in world coordinates."""
    dev = torch.device(device if device is not None else "cuda")
    lin = torch.from_numpy(np.linspace(-bound, bound, resolution,
                                       dtype=np.float32)).to(dev)
    n = resolution**3
    vals = []
    for start in range(0, n + (-n) % chunk, chunk):
        i = torch.arange(start, start + chunk, device=dev)
        z, y, x = (i // resolution**2, (i // resolution) % resolution,
                   i % resolution)
        pts = torch.stack([lin[x.clamp(max=resolution - 1)],
                           lin[y.clamp(max=resolution - 1)],
                           lin[z.clamp(max=resolution - 1)]], -1)
        pts = torch.where((i < n)[:, None], pts, 0.0)
        vals.append(density_fn(pts).to(torch.float32))
    grid = torch.cat(vals)[:n].reshape(resolution, resolution, resolution)
    spacing = 2 * bound / (resolution - 1)
    return marching_tetrahedra(grid.cpu().numpy(), threshold,
                               origin=(-bound, -bound, -bound),
                               spacing=(spacing, spacing, spacing))


def save_mesh(path: str, verts: np.ndarray, tris: np.ndarray):
    """Write an ASCII .ply, or an .obj by extension."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if os.path.splitext(path)[1].lower() == ".obj":
        from seal3d_tpu_torch.seal.geometry import export_obj

        export_obj(path, verts, tris)
        return
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(tris)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
