"""NGP NeRF CLI over the port (counterpart of main_nerf.py). Training:

    python -m seal3d_tpu_torch.main_nerf synthetic -O --bound 1.0 \\
        --dt_gamma 0 --min_near 0.05 --max_steps 512 --iters 576 \\
        --H 256 --W 256 --workspace <ws>

trains from scratch (or resumes the workspace's latest checkpoint), saves
`<ws>/checkpoints/ngp_step<step>.npz` with the optimizer state, prints the
val split's `[eval] PSNR` and renders the test split to `<ws>/results/`
(PNGs, plus mp4s where imageio or cv2 is installed). With `--test --ckpt
<file.npz>` it loads a checkpoint written by either package and only
renders. `--ckpt <file.pth>` loads the params of an upstream torch-ngp /
Seal-3D checkpoint (or one written by `export_torch_ngp`) into `params`
only, as the reference does: the EMA params that renders use, the
optimizer state and the occupancy grid keep their init values (ROADMAP.md
Queue 3). `--grid_backend bucket` (the reference's T=2^19 hash grid) and
`--grid_backend pallas` (T=2^15, levels padded) select the hash-encode
kernels. The GUI, mesh export, the dense renderer, error-map sampling,
CLIP-guided random poses and bound > 1 are not ported yet (ROADMAP.md
Queue 1) and raise NotImplementedError.
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


def _refuse_unported(args):
    item = None
    if args.gui or args.save_mesh:
        item = ("--gui and --save_mesh", "Other backends and families")
    elif args.dense_render:
        item = ("--dense_render", "1l eval")
    elif args.error_map or args.clip_text or args.rand_pose >= 0:
        item = ("--error_map and CLIP-guided --rand_pose", "Train step")
    elif args.bound > 1 and not args.test:
        item = ("training at bound > 1 (multi-cascade march)", "1l eval")
    if item:
        raise NotImplementedError(f"{item[0]}: not ported yet (ROADMAP.md "
                                  f"Queue 1, '{item[1]}')")


def main(argv=None) -> Trainer:
    parser = common_parser("seal3d-tpu NGP NeRF (PyTorch port)")
    parser.add_argument("--clip_text", type=str, default="")
    parser.add_argument("--rand_pose", type=int, default=-1)
    args = parser.parse_args(argv)
    _refuse_unported(args)
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = NGPConfig(bound=args.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype,
                     bg_radius=args.bg_radius)
    opts = build_options(args)
    tcfg = build_train_config(args)
    ds = load_dataset(args, "test" if args.test else "trainval",
                      device=args.device)

    tr = Trainer(ngp, fcfg, opts, tcfg, dataset=ds, seed=args.seed,
                 device=args.device, name="ngp")
    tr.init_state()
    path = args.ckpt
    if path == "latest" and tcfg.workspace:
        path = ckpt_io.latest_checkpoint(
            os.path.join(tcfg.workspace, "checkpoints"), "ngp")
    if path and path != "scratch" and os.path.exists(path):
        if path.endswith(".pth"):
            tr.state = tr.state._replace(params=ckpt_io.import_torch_ngp(
                path, tr.state.params, grid_cfg=fcfg.grid))
        else:
            tr.load_checkpoint(path)
        print(f"[ckpt] loaded {path}")
    elif args.test:
        raise SystemExit(f"--test needs a checkpoint; none at {args.ckpt!r}")

    if not args.test:
        tr.train(steps=args.iters)
        tr.save_checkpoint()
        val_ds = load_dataset(args, "val", device=args.device)
        psnr = tr.evaluate(dataset=val_ds)
        print(f"[eval] PSNR {psnr:.2f} over {len(val_ds)} val views")
        test_ds = load_dataset(args, "test", device=args.device)
    else:
        test_ds = ds

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
