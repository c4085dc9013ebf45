"""The port's mesh2config (python -m seal3d_tpu_torch.mesh2config) against
the JAX package's scripts/mesh2config.py on the CPU: both read the same
small ascii mesh the test writes (an .obj of 600 vertices, which both
subsample to 512, and a .ply of 8) with a rotation, translation, scale and
colour, and write the same seal.json, byte for byte; the port builds its
bbox mapper from the file.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from seal3d_tpu_torch import mesh2config
from seal3d_tpu_torch.seal.mappers import build_mapper, load_mapper_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_mesh(path, n):
    rng = np.random.default_rng(n)
    verts = rng.uniform(-0.4, 0.4, (n, 3))
    faces = rng.integers(0, n, (n // 2, 3))
    with open(path, "w") as f:
        if path.endswith(".obj"):
            f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
        else:
            f.write(f"ply\nformat ascii 1.0\nelement vertex {n}\n"
                    f"property float x\nproperty float y\nproperty float z\n"
                    f"element face {len(faces)}\n"
                    f"property list uchar int vertex_indices\nend_header\n")
            f.writelines(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
            f.writelines(f"3 {a} {b} {c}\n" for a, b, c in faces)


@pytest.mark.parametrize("name,n", [("mesh.obj", 600), ("mesh.ply", 8)])
def test_mesh2config_matches_jax_script(name, n, tmp_path, monkeypatch):
    mesh = str(tmp_path / name)
    _write_mesh(mesh, n)
    opts = ["--translate", "0.1", "0.2", "-0.05", "--rotate_z_deg", "30",
            "--scale", "1.5", "1", "0.5", "--rgb", "0.9", "0.2", "0.1"]
    spec = importlib.util.spec_from_file_location(
        "jax_mesh2config", os.path.join(ROOT, "scripts", "mesh2config.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["mesh2config.py", mesh, "--out",
                                      str(tmp_path / "jax")] + opts)
    script.main()
    path = mesh2config.main([mesh, "--out", str(tmp_path / "port")] + opts)
    with open(path) as f, open(tmp_path / "jax" / "seal.json") as g:
        port, ref = f.read(), g.read()
    assert port == ref
    m = build_mapper(load_mapper_config(str(tmp_path / "port")))
    assert m.kind == "bbox" and "rgb" in m.flags
    cfg = load_mapper_config(str(tmp_path / "port"))
    assert len(cfg["raw"]) == min(n, 512)
