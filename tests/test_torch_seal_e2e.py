"""The port's Seal editing CLI end to end on the CPU at a tiny size, and its
off-path options.

The run is the bbox recipe (`seal_config_bbox/seal.json`) through
`seal3d_tpu_torch.main_SealNeRF`: 4 levels at T=2^12 (the CLI's NGPConfig is
narrowed here; the CLI itself has no level option), 24x24 views, a teacher
trained in the same call, coarse pretraining shells, a few epochs and a few
dozen finetune steps, on the CPU through the kernels' plain versions. The
brush (line and curve) and anchor tools run the same CLI on a teacher
trained once for the module, through pretraining (the finetune stage does
not depend on the tool; the card runs it for every tool). The CLI also runs
at its default bound 2, through --dense_render and with --save_mesh.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import test_torch_seal_cases as tool_cases
from seal3d_tpu_torch import main_SealNeRF
from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, refuse_unported)
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


def _narrow(monkeypatch):
    monkeypatch.setattr(main_SealNeRF, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))


def _teacher_checkpoint(path, argv, steps=0, name="sealnerf_teacher"):
    """A teacher of the CLI's configuration (argv), trained `steps` steps
    on the CLI's dataset through the Trainer API, saved to `path`."""
    from seal3d_tpu_torch.config import grid_defaults, load_dataset
    from seal3d_tpu_torch.train.trainer import Trainer

    args = main_SealNeRF.add_seal_args(common_parser("t")).parse_args(argv)
    backend, log2t, gridtype = grid_defaults(args)
    fcfg = tngp.NGPConfig(bound=args.bound, log2_hashmap_size=log2t,
                          num_levels=4, grid_backend=backend,
                          gridtype=gridtype)
    ds = load_dataset(args, "trainval", device="cpu") if steps else None
    teacher = Trainer(tngp, fcfg, build_options(args),
                      build_train_config(args), dataset=ds, device="cpu",
                      name=name)
    teacher.init_state()
    if steps:
        teacher.train(steps=steps)
    return teacher.save_checkpoint(path)


@pytest.fixture(scope="module")
def trained_teacher(tmp_path_factory):
    """A bound-1 teacher trained 16 steps (one full grid update), for the
    brush and anchor edits."""
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.npz")
    return _teacher_checkpoint(path, ARGV, steps=16)


def _tool_config(tmp_path, name):
    """A seal.json directory holding tests/test_torch_seal_cases.py's
    config `name`."""
    cfg_dir = tmp_path / f"cfg_{name}"
    cfg_dir.mkdir()
    (cfg_dir / "seal.json").write_text(json.dumps(tool_cases.CONFIGS[name]))
    return str(cfg_dir)


TOOL_CASES = {"brush_line": "line", "brush_curve": "curve",
              "anchor": "anchor"}


@pytest.mark.parametrize("tool", ["bbox", *TOOL_CASES])
def test_cli_edits_a_scene(tool, tmp_path, monkeypatch, capsys, request):
    """bbox: teacher trained from scratch, the edit distilled, edited views
    written: the files of a run exist, the pretrain loss falls, the finetune
    loss is finite and falls, the proxied dataset has depths, the edited
    views are finite and the force-fill is gone from the final bitfield.
    brush (line, curve) and anchor: the shared teacher, the edit's
    pretraining: the tool's files, a falling pretrain loss, local shell
    points the tool maps, finite edited views."""
    _narrow(monkeypatch)
    if tool != "bbox":
        return _tool_edit(TOOL_CASES[tool], tmp_path, capsys,
                          request.getfixturevalue("trained_teacher"))
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


def _tool_edit(name, tmp_path, capsys, teacher):
    ws = str(tmp_path / "student")
    argv = list(ARGV)
    argv[argv.index("--seal_config") + 1] = _tool_config(tmp_path, name)
    st = main_SealNeRF.main(argv + SIZE + [
        "--workspace", ws, "--teacher_ckpt", teacher, "--num_views", "6",
        "--pretraining_epochs", "14", "--pretraining_only"])
    out = capsys.readouterr().out
    assert f"[teacher] loaded {teacher}" in out
    kind = tool_cases.CONFIGS[name]["type"]
    assert st.mapper.kind == kind
    for f in ("timer.json", "seal.json", "options.json",
              "to.obj" if kind == "anchor" else "to.ply"):
        assert os.path.exists(os.path.join(ws, f)), f
    with open(os.path.join(ws, "seal.json")) as f:
        assert json.load(f) == tool_cases.CONFIGS[name]
    losses = np.asarray(st.pretrain_losses)
    assert losses.shape == (14,) and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    local = st.pretrain_data["local"]
    n = int(local["weight"].sum())
    pts = local["points"].reshape(-1, 3)[:n]
    from seal3d_tpu_torch.seal.mappers import map_to_origin

    mapped, _, mask = map_to_origin(st.mapper, pts, None)
    assert n > 0 and bool(mask.any())
    assert float((mapped - pts).abs().max()) > 0.01   # the tool moves points
    assert len(st.render_stats) >= 8
    assert all(s_["nonfinite"] == 0 for s_ in st.render_stats)


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


def test_unported_options_raise(tmp_path, monkeypatch, capsys):
    """The Seal CLI's --gui opens the editing viewer, which needs dearpygui:
    without it, the RuntimeError naming it, before anything is trained;
    --error_map passes the refusal; the card is the default device. The options it refused before
    now run: the default bound 2 (two cascades) with a brush edit and
    --save_mesh, and --dense_render with an anchor edit on a teacher trained
    through the dense oracle."""
    with pytest.raises(RuntimeError, match="dearpygui"):
        main_SealNeRF.main(ARGV + ["--gui"])
    refuse_unported(main_SealNeRF.add_seal_args(common_parser("t"))
                    .parse_args(ARGV + ["--error_map"]))
    if not torch.cuda.is_available():
        argv = [a for a in ARGV if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_SealNeRF.main(argv + ["--workspace", str(tmp_path / "ws")])
    _narrow(monkeypatch)

    # the CLI's defaults: bound 2.0, dt_gamma 1/128
    argv = [a for a in ARGV if a not in ("--bound", "1.0", "--dt_gamma", "0")]
    argv[argv.index("--seal_config") + 1] = _tool_config(tmp_path, "line")
    teacher = _teacher_checkpoint(str(tmp_path / "teacher2.npz"), argv)
    ws = str(tmp_path / "bound2")
    argv[argv.index("--max_steps") + 1] = "64"
    st = main_SealNeRF.main(argv + SIZE + [
        "--workspace", ws, "--teacher_ckpt", teacher, "--pretraining_epochs",
        "2", "--pretraining_only", "--lr", "3e-3", "--num_views", "4",
        "--save_mesh", "--mesh_resolution", "24"])
    assert st.opts.bound == 2.0 and st.opts.cascades == 2
    assert st.opts.dt_gamma == 1 / 128 and st.mapper.kind == "brush"
    assert st.state.occ.bitfield.shape == (2 * 2**21 // 8,)
    assert np.all(np.isfinite(st.pretrain_losses))
    assert all(s_["nonfinite"] == 0 for s_ in st.render_stats)
    mesh = os.path.join(ws, "meshes", "sealnerf.ply")
    with open(mesh) as f:
        head = f.read(200)
    assert head.startswith("ply\nformat ascii 1.0\nelement vertex ")
    assert "[mesh]" in capsys.readouterr().out

    # --dense_render: the teacher trains and renders through the oracle
    argv = list(ARGV)
    argv[argv.index("--seal_config") + 1] = _tool_config(tmp_path, "anchor")
    ws, tws = str(tmp_path / "dense"), str(tmp_path / "dense_teacher")
    st = main_SealNeRF.main(argv + SIZE + [
        "--workspace", ws, "--teacher_workspace", tws, "--teacher_ckpt",
        "scratch", "--train_teacher", "8", "--dense_render",
        "--num_steps", "16", "--upsample_steps", "16", "--num_views", "4",
        "--pretraining_epochs", "2", "--pretraining_only"])
    out = capsys.readouterr().out
    assert "[teacher] training 8 steps" in out and "[teacher] PSNR" in out
    assert os.path.exists(os.path.join(
        tws, "checkpoints", "sealnerf_teacher_step0000008.npz"))
    assert st.mapper.kind == "anchor" and not st.use_dense
    assert np.all(np.isfinite(st.pretrain_losses))
