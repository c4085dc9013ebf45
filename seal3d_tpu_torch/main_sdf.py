"""SDF fitting CLI over the port (counterpart of main_sdf.py). At the CLI's
defaults (T=2^19, 16,384 points a step):

    python -m seal3d_tpu_torch.main_sdf synthetic --iters 2000 \\
        --workspace <ws>

fits the signed distance of a box mesh normalized to [-0.6, 0.6]^3 (or of
the ascii .obj / .ply mesh given as the path, normalized to 0.8), prints the
MAE on a fresh batch (`[eval] SDF MAE`) and writes the zero level set to
`<ws>/sdf_mesh.ply`. `--test` skips the fit. Add `--device cpu` to run on
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from seal3d_tpu_torch.config import refuse_unported
from seal3d_tpu_torch.data.sdf_provider import SDFDataset
from seal3d_tpu_torch.models.sdf import SDFConfig
from seal3d_tpu_torch.seal.geometry import box_mesh_from_aabb
from seal3d_tpu_torch.train.sdf_trainer import SDFTrainer
from seal3d_tpu_torch.utils.seeding import seed_everything


def main(argv=None) -> SDFTrainer:
    p = argparse.ArgumentParser(description="seal3d-tpu SDF fitting "
                                            "(PyTorch port)")
    p.add_argument("path", type=str,
                   help="mesh path (.obj/.ply) or 'synthetic'")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless 'cpu' is given")
    p.add_argument("--workspace", type=str, default="workspace_sdf")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num_points", type=int, default=16384)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--clip_sdf", type=float, default=None)
    p.add_argument("--test", action="store_true")
    p.add_argument("--mesh_resolution", type=int, default=256)
    args = p.parse_args(argv)
    refuse_unported(args)
    seed_everything(args.seed)
    if args.path == "synthetic":
        verts, faces = box_mesh_from_aabb(np.array([[-1, -1, -1],
                                                    [1, 1, 1.0]]))
        ds = SDFDataset(verts=verts, faces=faces, scale=0.6, seed=args.seed,
                        device=args.device)
    else:
        ds = SDFDataset(mesh_path=args.path, seed=args.seed,
                        device=args.device)
    cfg = SDFConfig(log2_hashmap_size=args.log2_hashmap_size,
                    clip_sdf=args.clip_sdf)
    tr = SDFTrainer(cfg, ds, lr=args.lr, num_points=args.num_points,
                    seed=args.seed, workspace=args.workspace)
    if not args.test:
        tr.train(steps=args.iters)
    print(f"[eval] SDF MAE = {tr.evaluate():.5f}")
    os.makedirs(args.workspace, exist_ok=True)
    path = os.path.join(args.workspace, "sdf_mesh.ply")
    verts, _ = tr.save_mesh(path, resolution=args.mesh_resolution)
    print(f"[mesh] wrote {path} ({len(verts)} verts)")
    return tr


if __name__ == "__main__":
    main(sys.argv[1:])
