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
kernels. The defaults `--bound 2.0 --dt_gamma 1/128` train the two-cascade
field with the cone-stepped single-level march (the reference trains bound
2 at `--lr 3e-3`: lr 1e-2 collapses the field there); `--dense_render`
trains and renders through the dense oracle, with no occupancy grid.
`--save_mesh` writes `<ws>/meshes/ngp.ply`: the EMA field's density on a
`--mesh_resolution`^3 lattice, its iso-surface at min(10, the occupancy
grid's mean density). `--error_map` draws each step's pixels in proportion
to a per-view error map; `--bg_radius R` (R > 0) adds the background net.
`--clip_text T --rand_pose N` adds CLIP-guided steps on random orbit poses
(every step at N = 0, one per N steps above), with a local transformers
CLIP checkpoint (`--clip_model_path`) or a randomly initialised one
(`--clip_random_init`); without a usable CLIP the CLI exits with the JAX
CLI's message. The GUI is not ported yet (ROADMAP.md Queue 1) and raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
import sys

from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, grid_defaults,
                                     load_dataset, refuse_unported)
from seal3d_tpu_torch.models import ngp
from seal3d_tpu_torch.models.ngp import NGPConfig
from seal3d_tpu_torch.runtime.mesh_export import extract_geometry, save_mesh
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.trainer import Trainer
from seal3d_tpu_torch.train.video import write_test_outputs
from seal3d_tpu_torch.utils.seeding import seed_everything


def main(argv=None) -> Trainer:
    parser = common_parser("seal3d-tpu NGP NeRF (PyTorch port)")
    parser.add_argument("--clip_text", type=str, default="",
                        help="text prompt for CLIP guidance")
    parser.add_argument("--clip_model_path", type=str, default=None,
                        help="local transformers CLIP checkpoint directory")
    parser.add_argument("--clip_random_init", action="store_true",
                        help="random-weight CLIP (the guidance math runs, "
                             "its direction is meaningless)")
    parser.add_argument("--rand_pose", type=int, default=-1,
                        help="<0 off, 0 = every step a CLIP-guided random "
                             "pose, >0 one guided step per N gt steps")
    args = parser.parse_args(argv)
    refuse_unported(args)
    seed_everything(args.seed)
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = NGPConfig(bound=args.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype,
                     bg_radius=args.bg_radius)
    opts = build_options(args)
    tcfg = build_train_config(args)
    ds = load_dataset(args, "test" if args.test else "trainval",
                      device=args.device)

    clip_loss = None
    if args.clip_text and args.rand_pose >= 0:
        from seal3d_tpu_torch.utils.clip_guidance import CLIPLoss

        clip_loss = CLIPLoss(args.clip_text, model_path=args.clip_model_path,
                             random_init=args.clip_random_init,
                             device=args.device)
        if not clip_loss.available:
            raise SystemExit("--clip_text needs --clip_model_path (local "
                             "weights) or --clip_random_init")
        tcfg = dataclasses.replace(tcfg, rand_pose=args.rand_pose)

    tr = Trainer(ngp, fcfg, opts, tcfg, dataset=ds, seed=args.seed,
                 device=args.device, name="ngp", use_dense=args.dense_render,
                 clip_loss=clip_loss)
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

    if args.save_mesh:
        verts, tris = extract_geometry(
            lambda x: ngp.density(tr.state.ema_params, fcfg, x)["sigma"],
            bound=args.bound, resolution=args.mesh_resolution,
            threshold=min(10.0, float(tr.state.occ.mean_density)),
            device=args.device)
        save_mesh(os.path.join(tcfg.workspace, "meshes", "ngp.ply"), verts,
                  tris)
        print(f"[mesh] {len(verts)} verts, {len(tris)} tris")
    return tr


if __name__ == "__main__":
    main(sys.argv[1:])
