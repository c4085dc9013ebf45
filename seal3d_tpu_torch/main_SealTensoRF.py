"""Seal-3D editing CLI over the port, TensoRF backbone (counterpart of
main_SealTensoRF.py): main_SealNeRF's edit (`run_seal`) with TensoRF
teachers and student.

    python -m seal3d_tpu_torch.main_SealTensoRF synthetic -O --bound 1.0 \\
        --dt_gamma 0 --min_near 0.05 --max_steps 512 --H 256 --W 256 \\
        --seal_config seal_config_bbox --teacher_ckpt <tensorf .npz> \\
        --pretraining_epochs 50 --extra_epochs 500 --workspace <ws>

The teacher (and a secondary teacher) is a TensoRFTrainer built at
`--resolution0` with no upsample or shrink of its own; its `.npz` loads at
the file's factor shapes, whatever upsamples and shrink made them. The
student trains with the base trainer's one Adam over every leaf, `aabb`
included (the reference's behaviour). `--train_teacher N` trains the
teacher first; a `.pth` teacher raises ValueError, as in the reference.

`--pretraining_lr` defaults to 0.005 here, a tenth of main_SealNeRF's (the
JAX package's main_SealTensoRF keeps 0.05): the pretraining moves every
TensoRF leaf, the colour net and basis matrix too, and at 0.05 its Adam
saturates the colour net's sigmoid within a few epochs, so that the student
renders white and the finetune cannot bring it back (PERF.md section 6).
"""

from __future__ import annotations

import sys

from seal3d_tpu_torch.config import (build_options, common_parser,
                                     refuse_unported)
from seal3d_tpu_torch.main_SealNeRF import add_seal_args, run_seal
from seal3d_tpu_torch.models import tensorf
from seal3d_tpu_torch.models.tensorf import TensoRFConfig
from seal3d_tpu_torch.seal.trainer import SealTrainer
from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer

# the pretraining's Adam rate for a TensoRF student (see the docstring)
SEAL_TENSORF_PRETRAINING_LR = 0.005


def main(argv=None) -> SealTrainer:
    parser = add_seal_args(common_parser("seal3d-tpu Seal editing (TensoRF, "
                                         "PyTorch port)"))
    parser.add_argument("--cp", action="store_true")
    parser.add_argument("--resolution0", type=int, default=128)
    parser.set_defaults(pretraining_lr=SEAL_TENSORF_PRETRAINING_LR)
    args = parser.parse_args(argv)
    refuse_unported(args)
    fcfg = TensoRFConfig(bound=args.bound,
                         decomposition="cp" if args.cp else "vm",
                         resolution=(args.resolution0,) * 3)

    def make_trainer(tcfg, ds, name):
        return TensoRFTrainer(fcfg, build_options(args), tcfg, dataset=ds,
                              seed=args.seed, device=args.device, name=name,
                              upsample_steps=(), shrink_step=None,
                              use_dense=args.dense_render)

    return run_seal(args, tensorf, fcfg, make_trainer, "sealtensorf",
                    family="tensorf")


if __name__ == "__main__":
    main(sys.argv[1:])
