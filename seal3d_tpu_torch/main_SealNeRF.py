"""Seal-3D editing CLI over the port, NGP backbone (counterpart of
main_SealNeRF.py): load or train a teacher, build the proxy mapper from a
seal config (the bbox, brush or anchor tool), distill the edit into a
student with the two-stage schedule, render the edited test views.

    python -m seal3d_tpu_torch.main_SealNeRF synthetic -O --bound 1.0 \\
        --dt_gamma 0 --min_near 0.05 --max_steps 512 \\
        --seal_config seal_config_bbox --teacher_ckpt <teacher.npz> \\
        --pretraining_epochs 50 --extra_epochs 500 --workspace <ws>

writes `<ws>/timer.json`, `seal.json`, `options.json`, `run.sh`, the
student's checkpoint and `<ws>/results/` (PNGs, plus mp4s where imageio or
cv2 is installed); with `--save_mesh` also `<ws>/meshes/sealnerf.ply`, the
student's iso-surface. `--train_teacher N` trains the teacher first instead
of loading one. The CLI's defaults `--bound 2.0 --dt_gamma 1/128` edit a
two-cascade field (train it at `--lr 3e-3`, as main_nerf); with
`--dense_render` the teacher trains and renders through the dense oracle
while the student keeps the occupancy-grid path, as in the reference.
`--error_map` samples the teacher's and the student's train rays from
their error maps. `--gui` raises NotImplementedError naming its ROADMAP.md
item.
"""

from __future__ import annotations

import os
import sys

from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, grid_defaults,
                                     load_dataset, refuse_unported)
from seal3d_tpu_torch.models import ngp
from seal3d_tpu_torch.models.ngp import NGPConfig
from seal3d_tpu_torch.runtime.mesh_export import extract_geometry, save_mesh
from seal3d_tpu_torch.seal.mappers import build_mapper, load_mapper_config
from seal3d_tpu_torch.seal.provider import seal_random_dataset
from seal3d_tpu_torch.seal.trainer import PretrainConfig, SealTrainer
from seal3d_tpu_torch.train import checkpoint as ckpt_io
from seal3d_tpu_torch.train.trainer import Trainer
from seal3d_tpu_torch.train.video import write_test_outputs


def add_seal_args(parser):
    parser.add_argument("--seal_config", type=str, required=True,
                        help="dir containing seal.json (the edit config)")
    parser.add_argument("--teacher_workspace", type=str, default="workspace")
    parser.add_argument("--teacher_ckpt", type=str, default="latest")
    parser.add_argument("--train_teacher", type=int, default=0,
                        help="train the teacher for N steps first (no ckpt)")
    parser.add_argument("--pretraining_epochs", type=int, default=100)
    parser.add_argument("--pretraining_batch_size", type=int, default=2**19)
    parser.add_argument("--pretraining_lr", type=float, default=0.05)
    parser.add_argument("--pretraining_local_point_step", type=float,
                        default=0.005)
    parser.add_argument("--pretraining_surrounding_point_step", type=float,
                        default=0.01)
    parser.add_argument("--pretraining_global_point_step", type=float,
                        default=0.05)
    parser.add_argument("--extra_epochs", type=int, default=0,
                        help="finetune steps after pretraining (0 = none)")
    parser.add_argument("--pretraining_only", action="store_true")
    parser.add_argument("--custom_pose", action="store_true",
                        help="use edit-centered random poses for finetuning")
    parser.add_argument("--secondary_teacher_ckpt", type=str, default=None,
                        help="checkpoint of a second teacher model answering "
                             "mapped-region queries (cross-scene editing)")
    return parser


def run_seal(args, field_mod, fcfg, make_trainer, name,
             family: str = "ngp") -> SealTrainer:
    """The edit of one backbone: `make_trainer(tcfg, ds, name)` builds its
    teacher trainer; `family` ('ngp' or 'tensorf') picks the train config's
    eval chunk. A `.pth` teacher is read as NGP params, as the reference
    reads it: another family's raises ValueError."""
    opts = build_options(args)
    tcfg = build_train_config(args, family=family)
    # the edit first: a config of an unknown tool fails before any training
    mapper = build_mapper(load_mapper_config(args.seal_config),
                          workspace=tcfg.workspace)
    ds = load_dataset(args, "trainval", device=args.device)

    # ---- teacher
    teacher_tcfg = build_train_config(args, family=family)
    teacher_tcfg.workspace = args.teacher_workspace
    teacher = make_trainer(teacher_tcfg, ds, name=f"{name}_teacher")
    teacher.init_state()
    loaded = False
    if args.teacher_ckpt and args.teacher_ckpt != "scratch":
        path = args.teacher_ckpt
        if path == "latest":
            path = ckpt_io.latest_checkpoint(
                os.path.join(args.teacher_workspace, "checkpoints"),
                f"{name}_teacher")
        if path and os.path.exists(path):
            if path.endswith(".pth"):
                if family != "ngp":
                    raise ValueError(
                        f"--teacher_ckpt {path}: a .pth teacher is read as "
                        f"NGP params (the JAX package's main_SealNeRF.py, "
                        f"which has no {family} .pth teacher either); give "
                        f"an .npz checkpoint of the {family} teacher")
                teacher.state = teacher.state._replace(
                    params=ckpt_io.import_torch_ngp(
                        path, teacher.state.params, grid_cfg=fcfg.grid))
            else:
                teacher.load_checkpoint(path)
            loaded = True
            print(f"[teacher] loaded {path}")
    if not loaded or args.train_teacher > 0:
        steps = args.train_teacher or args.iters
        print(f"[teacher] training {steps} steps")
        teacher.train(steps=steps)
        teacher.save_checkpoint()
        print(f"[teacher] PSNR {teacher.evaluate(max_views=2):.2f}")

    # ---- student
    secondary = {}
    if args.secondary_teacher_ckpt:
        sec = make_trainer(teacher_tcfg, ds, name=f"{name}_teacher2")
        sec.init_state()
        sec.load_checkpoint(args.secondary_teacher_ckpt)
        secondary = dict(secondary_field=field_mod, secondary_cfg=fcfg,
                         secondary_params=sec.state.params)
        print(f"[teacher2] loaded {args.secondary_teacher_ckpt}")
    student = SealTrainer(field_mod, fcfg, opts, tcfg, mapper,
                          teacher_params=teacher.state.params,
                          teacher_bitfield=teacher.state.occ.bitfield,
                          dataset=ds, seed=args.seed + 1, device=args.device,
                          name=f"{name}_student", **secondary)
    student.init_state()
    if args.custom_pose:
        student.attach_dataset(seal_random_dataset(
            mapper, 24, ds.h, ds.w, ds.intrinsics, seed=args.seed))

    pcfg = PretrainConfig(
        epochs=args.pretraining_epochs,
        batch_size=args.pretraining_batch_size,
        lr=args.pretraining_lr,
        local_point_step=args.pretraining_local_point_step,
        surrounding_point_step=args.pretraining_surrounding_point_step,
        global_point_step=args.pretraining_global_point_step)
    finetune = 0 if args.pretraining_only else (args.extra_epochs or args.iters)
    timer = student.train_edit(pcfg, finetune_steps=finetune)
    print(f"[seal] pretraining {timer['pretraining_total']:.1f}s "
          f"+ finetune {timer['training_total']:.1f}s "
          f"(proxy {timer['proxy_dataset']:.1f}s)")
    student.save_checkpoint()

    # ---- results: the edited scene's test views
    test_ds = load_dataset(args, "test", device=args.device)

    def render_view(vi):
        img, depth = student.render_image(test_ds.poses[vi], test_ds.h,
                                          test_ds.w)
        return img.cpu().numpy(), depth.cpu().numpy()

    out_dir = os.path.join(tcfg.workspace, "results")
    written = write_test_outputs(render_view, len(test_ds), out_dir, name)
    print(f"[test] wrote {len(test_ds)} edited views to {out_dir} "
          f"(video: {written['video']})")

    if args.save_mesh:
        verts, tris = extract_geometry(
            lambda x: field_mod.density(student.state.params, fcfg, x)["sigma"],
            bound=args.bound, resolution=args.mesh_resolution,
            threshold=min(10.0, float(student.state.occ.mean_density)),
            device=args.device)
        save_mesh(os.path.join(tcfg.workspace, "meshes", f"{name}.ply"),
                  verts, tris)
        print(f"[mesh] {len(verts)} verts, {len(tris)} tris")
    return student


def main(argv=None) -> SealTrainer:
    parser = add_seal_args(common_parser("seal3d-tpu Seal editing (NGP, "
                                         "PyTorch port)"))
    args = parser.parse_args(argv)
    refuse_unported(args)
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = NGPConfig(bound=args.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype,
                     bg_radius=args.bg_radius)

    def make_trainer(tcfg, ds, name):
        return Trainer(ngp, fcfg, build_options(args), tcfg, dataset=ds,
                       seed=args.seed, device=args.device, name=name,
                       use_dense=args.dense_render)

    return run_seal(args, ngp, fcfg, make_trainer, "sealnerf")


if __name__ == "__main__":
    main(sys.argv[1:])
