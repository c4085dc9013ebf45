"""The port's Seal editing CLI end to end on the CPU at a tiny size, and its
off-path options.

The run is the bbox recipe (`seal_config_bbox/seal.json`) through
`seal3d_tpu_torch.main_SealNeRF`: 4 levels at T=2^12 (the CLI's NGPConfig is
narrowed here; the CLI itself has no level option), 24x24 views, a teacher
trained in the same call, coarse pretraining shells, a few epochs and a few
dozen finetune steps, on the CPU through the kernels' plain versions.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from seal3d_tpu_torch import main_SealNeRF
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.seal.renderer import hack_bitfield
from seal3d_tpu_torch.train.checkpoint import flatten_tree


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ARGV = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0", "--min_near",
        "0.05", "--max_steps", "512", "--H", "24", "--W", "24", "--num_rays",
        "256", "--log2_hashmap_size", "12", "--device", "cpu",
        "--seal_config", "seal_config_bbox"]
SIZE = ["--pretraining_epochs", "6", "--pretraining_batch_size", "8192",
        "--pretraining_local_point_step", "0.04",
        "--pretraining_surrounding_point_step", "0.08",
        "--pretraining_global_point_step", "0.2", "--extra_epochs", "32"]


def test_cli_edits_a_scene(tmp_path, monkeypatch, capsys):
    """Teacher trained from scratch, bbox edit distilled, edited views
    written: the files of a run exist, the pretrain loss falls, the finetune
    loss is finite and falls, the proxied dataset has depths, the edited
    views are finite and the force-fill is gone from the final bitfield."""
    monkeypatch.setattr(main_SealNeRF, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))
    ws, tws = str(tmp_path / "student"), str(tmp_path / "teacher")
    st = main_SealNeRF.main(ARGV + SIZE + [
        "--workspace", ws, "--teacher_workspace", tws, "--teacher_ckpt",
        "scratch", "--train_teacher", "48"])
    out = capsys.readouterr().out
    assert "[teacher] training 48 steps" in out and "[seal] pretraining" in out

    for name in ("timer.json", "seal.json", "options.json", "run.sh",
                 "from.obj", "to.obj"):
        assert os.path.exists(os.path.join(ws, name)), name
    with open(os.path.join(ws, "timer.json")) as f:
        timer = json.load(f)
    assert len(timer["pretraining"]) == 6 and len(timer["training"]) == 1
    assert timer["proxy_dataset"] > 0 and timer["pretrain_init"] > 0
    with open(os.path.join(ws, "seal.json")) as f:
        assert json.load(f)["type"] == "bbox"
    assert os.path.exists(os.path.join(
        tws, "checkpoints", "sealnerf_teacher_step0000048.npz"))
    assert os.path.exists(os.path.join(
        ws, "checkpoints", "sealnerf_student_step0000032.npz"))

    losses = np.asarray(st.pretrain_losses)
    assert losses.shape == (6,) and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    hist = [h["loss"] for h in st.history]
    assert len(hist) >= 2 and np.all(np.isfinite(hist)), st.history
    assert hist[-1] < hist[0], st.history
    assert int(st.state.step) == 32

    # stage 2 trained on teacher renders with depths
    ds = st.dataset
    assert ds.images.dtype == np.uint8 and ds.images.shape[1:] == (24, 24, 3)
    assert ds.depths is not None and ds.depths.max() > 0

    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith("_rgb.png")]
    assert len(pngs) == 8
    assert len(st.render_stats) >= 8
    assert all(s["nonfinite"] == 0 for s in st.render_stats)

    # restore_grid dropped the force-fill: the student's own density decides
    forced = hack_bitfield(torch.zeros_like(st.state.occ.bitfield),
                           st._hack_bytes, st._hack_masks)
    bits = st.state.occ.bitfield
    assert int(forced.to(torch.int64).sum()) > 0
    assert not bool(((bits & forced) == forced).all())


def test_cli_loads_the_latest_teacher_and_pretrains_only(tmp_path,
                                                         monkeypatch, capsys):
    """`--teacher_ckpt latest` finds the teacher's checkpoint in its
    workspace; `--pretraining_only` stops after stage 1 (no proxy renders,
    no finetune step) and still writes the edited views."""
    monkeypatch.setattr(main_SealNeRF, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser)
    from seal3d_tpu_torch.train.trainer import Trainer

    tws = str(tmp_path / "teacher")
    args = main_SealNeRF.add_seal_args(common_parser("t")).parse_args(
        ARGV + ["--workspace", tws])
    fcfg = tngp.NGPConfig(bound=1.0, log2_hashmap_size=12, num_levels=4,
                          grid_backend="halo", gridtype="wrap")
    teacher = Trainer(tngp, fcfg, build_options(args),
                      build_train_config(args), device="cpu",
                      name="sealnerf_teacher")
    teacher.init_state()
    path = teacher.save_checkpoint()

    ws = str(tmp_path / "student")
    st = main_SealNeRF.main(ARGV + SIZE + [
        "--workspace", ws, "--teacher_workspace", tws,
        "--pretraining_epochs", "2", "--pretraining_only"])
    out = capsys.readouterr().out
    assert f"[teacher] loaded {path}" in out
    assert "[teacher] training" not in out
    assert len(st.pretrain_losses) == 2 and int(st.state.step) == 0
    with open(os.path.join(ws, "timer.json")) as f:
        timer = json.load(f)
    assert timer["training"] == [] and timer["proxy_dataset"] == 0.0
    assert st.dataset.depths is None
    saved = dict(flatten_tree(teacher.state.params))
    for k, v in flatten_tree(st.teacher_params):
        assert torch.equal(v, saved[k]), k
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith("_rgb.png")]) == 8


def test_unported_options_raise(tmp_path):
    """Every off-path option of the Seal CLI names its ROADMAP.md item, and
    does so before anything is trained; the card is the default device."""
    for extra in (["--gui"], ["--save_mesh"], ["--dense_render"],
                  ["--error_map"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main_SealNeRF.main(ARGV + extra)
    argv = list(ARGV)
    argv[argv.index("--bound") + 1] = "2.0"
    for extra in ([], ["--dense_render"]):
        with pytest.raises(NotImplementedError,
                           match="Seal editing: what stays"):
            main_SealNeRF.main(argv + extra)
    for kind in ("brush", "anchor"):
        cfg_dir = tmp_path / kind
        cfg_dir.mkdir()
        (cfg_dir / "seal.json").write_text(json.dumps({"type": kind}))
        argv = list(ARGV)
        argv[argv.index("--seal_config") + 1] = str(cfg_dir)
        with pytest.raises(NotImplementedError, match="Seal editing"):
            main_SealNeRF.main(argv + ["--workspace", str(tmp_path / "ws")])
    if not torch.cuda.is_available():
        argv = [a for a in ARGV if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_SealNeRF.main(argv + ["--workspace", str(tmp_path / "ws")])
