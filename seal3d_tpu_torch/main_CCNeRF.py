"""CCNeRF CLI over the port (counterpart of main_CCNeRF.py): rank-residual
training, then compression and composition. At the CLI's full width
(resolution 300^3, cumulative ranks vec density 8/8/8, mat density 0/16/24,
vec colour 24/24/24, mat colour 0/48/72, SH degree 3):

    python -m seal3d_tpu_torch.main_CCNeRF synthetic -O --bound 1.0 \\
        --H 256 --W 256 --iters 1000 --workspace <ws>

trains from scratch (or resumes the workspace's latest checkpoint) through
the dense oracle, saves `<ws>/checkpoints/ccnerf_step<step>.npz`, prints the
val split's `[eval] PSNR` and renders the test split with the params (not
the EMA) to `<ws>/results/`. `--compress vd md vc mc` keeps the top ranks of
each finalized family before the test renders; `--compose <ckpt> ...` adds
each checkpoint's object 0, finalized, at x + (0.4 (i + 1), 0, 0). `--ckpt`
takes an `.npz` of either package or a reference `.pth` (re-instantiated at
its ranks and resolution). Add `--device cpu` to run on the CPU. The GUI is
not ported yet (ROADMAP.md Queue 1) and raises NotImplementedError.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, load_dataset,
                                     refuse_unported)
from seal3d_tpu_torch.models import ccnerf
from seal3d_tpu_torch.models.ccnerf import CCNeRFConfig
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.cc_trainer import CCNeRFTrainer
from seal3d_tpu_torch.train.video import write_test_outputs
from seal3d_tpu_torch.utils.seeding import seed_everything


def main(argv=None) -> CCNeRFTrainer:
    parser = common_parser("seal3d-tpu CCNeRF (PyTorch port)")
    parser.add_argument("--rank_vec_density", type=int, nargs="*",
                        default=[8, 8, 8])
    parser.add_argument("--rank_mat_density", type=int, nargs="*",
                        default=[0, 16, 24])
    parser.add_argument("--rank_vec", type=int, nargs="*", default=[24, 24, 24])
    parser.add_argument("--rank_mat", type=int, nargs="*", default=[0, 48, 72])
    parser.add_argument("--compress", type=int, nargs=4, default=None,
                        help="(vd, md, vc, mc) top-rank slice after training")
    parser.add_argument("--compose", type=str, nargs="*", default=None,
                        help="checkpoints of other objects to compose in")
    args = parser.parse_args(argv)
    refuse_unported(args)
    seed_everything(args.seed)
    fcfg = CCNeRFConfig(bound=args.bound,
                        rank_vec_density=tuple(args.rank_vec_density),
                        rank_mat_density=tuple(args.rank_mat_density),
                        rank_vec=tuple(args.rank_vec),
                        rank_mat=tuple(args.rank_mat))
    opts = build_options(args)
    tcfg = build_train_config(args, family="tensorf")
    ds = load_dataset(args, "test" if args.test else "trainval",
                      device=args.device)
    tr = CCNeRFTrainer(fcfg, opts, tcfg, dataset=ds, seed=args.seed,
                       device=args.device)
    tr.init_state()
    path = args.ckpt
    if path == "latest" and tcfg.workspace:
        path = ckpt_io.latest_checkpoint(
            os.path.join(tcfg.workspace, "checkpoints"), "ccnerf")
    if path and path != "scratch" and os.path.exists(path):
        tr.load_checkpoint(path)
        print(f"[ckpt] loaded {path}")

    if not args.test:
        tr.train(steps=args.iters)
        tr.save_checkpoint()
        val_ds = load_dataset(args, "val", device=args.device)
        print(f"[eval] PSNR {tr.evaluate(dataset=val_ds):.2f} over "
              f"{len(val_ds)} val views")

    if args.compress:
        tr.state = tr.state._replace(
            params=ccnerf.compress(tr.state.params, tuple(args.compress)))
        print(f"[compress] ranks -> {args.compress}")

    if args.compose:
        scene = ccnerf.finalize(tr.state.params)
        for i, other_path in enumerate(args.compose):
            other = CCNeRFTrainer(tr.fcfg, opts, tcfg, dataset=ds, seed=i,
                                  device=args.device, name="ccnerf_other")
            other.init_state()
            other.load_checkpoint(other_path)
            scene = ccnerf.compose(scene, other.state.params,
                                   t=np.array([0.4 * (i + 1), 0, 0]))
        tr.state = tr.state._replace(params=scene)
        print(f"[compose] scene with {1 + len(args.compose)} objects")

    test_ds = load_dataset(args, "test", device=args.device)

    def render_view(vi):
        img, depth = tr.render_image(test_ds.poses[vi], test_ds.h, test_ds.w,
                                     use_ema=False)
        return img.cpu().numpy(), depth.cpu().numpy()

    out_dir = os.path.join(tcfg.workspace, "results")
    written = write_test_outputs(render_view, len(test_ds), out_dir, "ccnerf")
    print(f"[test] wrote {len(test_ds)} views to {out_dir} "
          f"(video: {written['video']})")
    return tr


if __name__ == "__main__":
    main(sys.argv[1:])
