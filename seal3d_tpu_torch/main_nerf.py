"""NGP NeRF CLI over the port (counterpart of main_nerf.py), test mode:

    python -m seal3d_tpu_torch.main_nerf synthetic -O --test --bound 1.0 \\
        --dt_gamma 0 --min_near 0.05 --max_steps 512 --ckpt <file.npz>

loads a checkpoint written by either package and renders the test split to
`<workspace>/results/` (PNGs, plus mp4s where imageio or cv2 is installed).
Training, the GUI and mesh export are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import os
import sys

from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, grid_defaults,
                                     load_dataset)
from seal3d_tpu_torch.models import ngp
from seal3d_tpu_torch.models.ngp import NGPConfig
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.trainer import Trainer
from seal3d_tpu_torch.train.video import write_test_outputs


def main(argv=None) -> Trainer:
    args = common_parser("seal3d-tpu NGP NeRF (PyTorch port)").parse_args(argv)
    if not args.test:
        raise SystemExit("training is not ported yet (ROADMAP.md Queue 1, "
                         "'Train step'): pass --test and --ckpt")
    if args.gui or args.save_mesh or args.dense_render:
        raise SystemExit("--gui, --save_mesh and --dense_render are not "
                         "ported yet (ROADMAP.md Queue 1)")
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = NGPConfig(bound=args.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype,
                     bg_radius=args.bg_radius)
    opts = build_options(args)
    tcfg = build_train_config(args)
    test_ds = load_dataset(args, "test", device=args.device)

    tr = Trainer(ngp, fcfg, opts, tcfg, dataset=test_ds, seed=args.seed,
                 device=args.device)
    tr.init_state()
    path = args.ckpt
    if path == "latest" and tcfg.workspace:
        path = ckpt_io.latest_checkpoint(
            os.path.join(tcfg.workspace, "checkpoints"), "ngp")
    if not path or path == "scratch" or not os.path.exists(path):
        raise SystemExit(f"--test needs a checkpoint; none at {args.ckpt!r}")
    if not path.endswith(".npz"):
        raise SystemExit("the port loads .npz checkpoints (reference .pth "
                         "import is not ported yet)")
    tr.load_checkpoint(path)
    print(f"[ckpt] loaded {path}")

    def render_view(vi):
        img, depth = tr.render_image(test_ds.poses[vi], test_ds.h, test_ds.w)
        return img.cpu().numpy(), depth.cpu().numpy()

    out_dir = os.path.join(tcfg.workspace, "results")
    written = write_test_outputs(render_view, len(test_ds), out_dir, "ngp")
    print(f"[test] wrote {len(test_ds)} views to {out_dir} "
          f"(video: {written['video']})")
    return tr


if __name__ == "__main__":
    main(sys.argv[1:])
