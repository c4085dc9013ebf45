"""TensoRF CLI over the port (counterpart of main_tensoRF.py). Training at
the CLI's full width (resolution 128^3 -> 300^3 over the five log-spaced
upsamples of --upsample_model_steps, the shrink at step 1000, sigma ranks
16x3, colour ranks 48x3, a 3x128 colour MLP):

    python -m seal3d_tpu_torch.main_tensoRF synthetic -O --bound 1.0 \\
        --dt_gamma 0 --min_near 0.05 --max_steps 512 --iters 1500 \\
        --H 256 --W 256 --upsample_model_steps 300 500 700 900 1100 \\
        --workspace <ws>

trains from scratch (or resumes the workspace's latest checkpoint, at its
own factor shapes), saves `<ws>/checkpoints/tensorf_step<step>.npz` with the
optimizer state, prints the val split's `[eval] PSNR` and renders the test
split to `<ws>/results/`. `--cp` selects the CP decomposition; `--test
--ckpt <file>` only renders, from an `.npz` of either package or a
reference `.pth` (re-instantiated at its resolution). `--bg_radius > 0`
trains the background net. Add `--device cpu` to run on the CPU (the
plain versions). `--error_map` draws the train rays from per-view error
maps. `--gui` raises ValueError: the reference has no viewer for this
CLI.
"""

from __future__ import annotations

import os
import sys

from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, load_dataset,
                                     refuse_unported)
from seal3d_tpu_torch.models.tensorf import TensoRFConfig
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer
from seal3d_tpu_torch.train.video import write_test_outputs


def main(argv=None) -> TensoRFTrainer:
    parser = common_parser("seal3d-tpu TensoRF (PyTorch port)")
    parser.add_argument("--cp", action="store_true", help="CP decomposition")
    parser.add_argument("--resolution0", type=int, default=128)
    parser.add_argument("--resolution1", type=int, default=300)
    parser.add_argument("--l1_reg_weight", type=float, default=1e-4)
    parser.add_argument("--upsample_model_steps", type=int, nargs="*",
                        default=[2000, 3000, 4000, 5500, 7000])
    args = parser.parse_args(argv)
    refuse_unported(args)
    fcfg = TensoRFConfig(
        bound=args.bound, decomposition="cp" if args.cp else "vm",
        resolution=(args.resolution0,) * 3, bg_radius=args.bg_radius)
    tcfg = build_train_config(args, family="tensorf")
    ds = load_dataset(args, "test" if args.test else "trainval",
                      device=args.device)

    tr = TensoRFTrainer(fcfg, build_options(args), tcfg, dataset=ds,
                        seed=args.seed, device=args.device,
                        l1_weight=args.l1_reg_weight,
                        upsample_steps=tuple(args.upsample_model_steps),
                        n_voxel_init=args.resolution0**3,
                        n_voxel_final=args.resolution1**3,
                        use_dense=args.dense_render)
    tr.init_state()
    path = args.ckpt
    if path == "latest" and tcfg.workspace:
        path = ckpt_io.latest_checkpoint(
            os.path.join(tcfg.workspace, "checkpoints"), "tensorf")
    if path and path != "scratch" and os.path.exists(path):
        tr.load_checkpoint(path)
        print(f"[ckpt] loaded {path}")
    elif args.test:
        raise SystemExit(f"--test needs a checkpoint; none at {args.ckpt!r}")

    if not args.test:
        tr.train(steps=args.iters)
        tr.save_checkpoint()
        val_ds = load_dataset(args, "val", device=args.device)
        print(f"[eval] PSNR {tr.evaluate(dataset=val_ds):.2f} over "
              f"{len(val_ds)} val views")
        test_ds = load_dataset(args, "test", device=args.device)
    else:
        test_ds = ds

    def render_view(vi):
        img, depth = tr.render_image(test_ds.poses[vi], test_ds.h, test_ds.w)
        return img.cpu().numpy(), depth.cpu().numpy()

    out_dir = os.path.join(tcfg.workspace, "results")
    written = write_test_outputs(render_view, len(test_ds), out_dir, "tensorf")
    print(f"[test] wrote {len(test_ds)} views to {out_dir} "
          f"(video: {written['video']})")
    return tr


if __name__ == "__main__":
    main(sys.argv[1:])
