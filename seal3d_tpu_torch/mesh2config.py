"""Write a bbox `seal.json` edit config from a mesh (counterpart of
scripts/mesh2config.py and of the reference's scripts/mesh2config.py:31-44:
the mesh's vertices, at most 512 of them evenly picked, become the `raw`
points; a rotation about z, a translation and a scale describe the edit).

    python -m seal3d_tpu_torch.mesh2config <mesh.obj|.ply> --out <dir> \\
        [--translate X Y Z] [--rotate_z_deg D] [--scale X Y Z] [--rgb R G B]

writes `<dir>/seal.json`, which `main_SealNeRF --seal_config <dir>` reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from seal3d_tpu_torch.data.sdf_provider import load_mesh


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mesh", help=".obj/.ply mesh marking the edit region")
    ap.add_argument("--out", default="seal_config")
    ap.add_argument("--translate", type=float, nargs=3, default=[0, 0, 0])
    ap.add_argument("--rotate_z_deg", type=float, default=0.0)
    ap.add_argument("--scale", type=float, nargs=3, default=[1, 1, 1])
    ap.add_argument("--rgb", type=float, nargs=3, default=None)
    args = ap.parse_args(argv)

    verts, _ = load_mesh(args.mesh)
    # subsample raw points (config stays small)
    if len(verts) > 512:
        verts = verts[np.linspace(0, len(verts) - 1, 512).astype(int)]
    th = np.deg2rad(args.rotate_z_deg)
    tf = np.eye(4)
    tf[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                           [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    tf[:3, 3] = args.translate
    cfg = {
        "type": "bbox",
        "raw": verts.tolist(),
        "transform": tf.tolist(),
        "scale": list(args.scale),
    }
    if args.rgb:
        cfg["rgb"] = list(args.rgb)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "seal.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    print(f"wrote {args.out}/seal.json")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
