"""D-NeRF CLI over the port (counterpart of main_dnerf.py). Training of the
deform variant at full width under -O (the 5x128 deform net, 16 levels F=2
at T=2^15 on K1, 64 time slices):

    python -m seal3d_tpu_torch.main_dnerf synthetic_dynamic -O --bound 1.0 \\
        --dt_gamma 0 --min_near 0.05 --max_steps 512 --H 256 --W 256 \\
        --num_views 48 --views_per_time 4 --time_multires 2 \\
        --deform_reg 1e-3 --iters 2000 --workspace <ws>

trains from scratch with the MLPs at a tenth of the rate (`lr_net_scale`
0.1), saves `<ws>/checkpoints/dnerf_step<step>.npz`, prints the val split's
`[eval] PSNR` (each view at its own time) and renders the test split to
`<ws>/results/`. `--variant basis|hyper` selects the other variants (hyper's
4-D grid is always on the plain gather); without -O the grid is the
`tiled` one on `xla`; `--grid_backend bucket` (or `pallas`) runs the hash
encode kernels, `bucket` with the positions' gradient. As in the reference
CLI, nothing is loaded: `--test` renders the fresh field. Add `--device cpu`
to run on the CPU (the plain versions). The GUI is not ported yet
(ROADMAP.md Queue 1) and raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, grid_defaults,
                                     load_dataset, refuse_unported)
from seal3d_tpu_torch.models.dnerf import DNeRFConfig
from seal3d_tpu_torch.train.dnerf_trainer import DNeRFTrainer
from seal3d_tpu_torch.train.video import write_test_outputs
from seal3d_tpu_torch.utils.seeding import seed_everything


def main(argv=None) -> DNeRFTrainer:
    parser = common_parser("seal3d-tpu D-NeRF (PyTorch port)")
    parser.add_argument("--variant", type=str, default="deform",
                        choices=["deform", "basis", "hyper"])
    parser.add_argument("--time_size", type=int, default=64)
    parser.add_argument("--deform_reg", type=float, default=0.0)
    parser.add_argument("--sigma_reg", type=float, default=0.0,
                        help="L1 density sparsity at random points")
    parser.add_argument("--time_multires", type=int, default=6,
                        help="frequency octaves of the time encoding")
    args = parser.parse_args(argv)
    refuse_unported(args)
    seed_everything(args.seed)
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = DNeRFConfig(bound=args.bound, variant=args.variant,
                       log2_hashmap_size=log2t, grid_backend=backend,
                       gridtype="tiled" if backend == "xla" else gridtype,
                       time_multires=args.time_multires)
    opts = build_options(args)
    # the reference trains the MLPs at lr / 10
    tcfg = dataclasses.replace(build_train_config(args), lr_net_scale=0.1)
    ds = load_dataset(args, "test" if args.test else "trainval",
                      device=args.device)
    tr = DNeRFTrainer(fcfg, opts, tcfg, dataset=ds, seed=args.seed,
                      device=args.device, time_size=args.time_size,
                      deform_reg=args.deform_reg, sigma_reg=args.sigma_reg,
                      use_dense=args.dense_render)
    tr.init_state()

    if not args.test:
        tr.train(steps=args.iters)
        tr.save_checkpoint()
        val_ds = load_dataset(args, "val", device=args.device)
        print(f"[eval] PSNR {tr.evaluate(dataset=val_ds):.2f} over "
              f"{len(val_ds)} val views")
        test_ds = load_dataset(args, "test", device=args.device)
    else:
        test_ds = ds
    times = (test_ds.times if test_ds.times is not None
             else np.linspace(0, 1, len(test_ds)))

    def render_view(vi):
        img, depth = tr.render_image_t(test_ds.poses[vi], test_ds.h,
                                       test_ds.w, float(times[vi]))
        return img.cpu().numpy(), depth.cpu().numpy()

    out_dir = os.path.join(tcfg.workspace, "results")
    written = write_test_outputs(render_view, len(test_ds), out_dir, "dnerf")
    print(f"[test] wrote {len(test_ds)} views to {out_dir} "
          f"(video: {written['video']})")
    return tr


if __name__ == "__main__":
    main(sys.argv[1:])
