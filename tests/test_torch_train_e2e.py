"""The port's train path end to end on the CPU, and checkpoints with the
optimizer state in both directions between the packages.

The CLI run is the -O command at a tiny size: 4 levels at T=2^12 (the CLI's
NGPConfig is narrowed here; the CLI itself has no level option), 256 rays,
24x24 views, 64 steps (4 full grid updates), on the CPU through the kernels'
plain versions.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch import main_nerf
from seal3d_tpu_torch.config import (build_options, build_train_config,
                                     common_parser, load_dataset,
                                     refuse_unported)
from seal3d_tpu_torch.data.synthetic import SyntheticScene as TScene
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from seal3d_tpu_torch.train.trainer import Trainer as TTrainer


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
        "0.05", "--max_steps", "512", "--iters", "64", "--H", "24", "--W",
        "24", "--num_rays", "256", "--log2_hashmap_size", "12", "--device",
        "cpu"]
SMALL = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
             grid_backend="halo", gridtype="wrap")


def test_cli_trains_and_psnr_rises(tmp_path, monkeypatch):
    """The untrained state renders background only; 64 steps later the val
    PSNR is clearly higher, the logged loss fell, and the final checkpoint
    carries the optimizer state under the reference's keys."""
    monkeypatch.setattr(main_nerf, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))
    ws = str(tmp_path / "ws")
    args = common_parser("t").parse_args(ARGV + ["--workspace", ws])
    val = load_dataset(args, "val", device="cpu")
    base = TTrainer(tngp, tngp.NGPConfig(**SMALL), build_options(args),
                    build_train_config(args), dataset=val, device="cpu")
    base.init_state()
    psnr0 = base.evaluate(val)

    tr = main_nerf.main(ARGV + ["--workspace", ws])
    psnr = tr.eval_history[-1]["psnr"]
    assert psnr > psnr0 + 2.0, (psnr0, psnr)
    assert tr.history[-1]["loss"] < 0.7 * tr.history[0]["loss"], tr.history
    assert int(tr.state.step) == 64
    st = tr.train_stats
    assert [full for full, _ in st["grid_updates"]] == [True] * 4
    assert st["window_steps"] == 16 and st["window_s"] > 0
    path = os.path.join(ws, "checkpoints", "ngp_step0000064.npz")
    with np.load(path) as data:
        assert int(data["opt_state/0/count"]) == 64
        assert int(data["opt_state/1/count"]) == 64
        assert "opt_state/0/nu/sigma_net/0/w" in data.files
    with np.load(os.path.join(ws, "checkpoints", "ngp_best.npz")) as data:
        assert not any(k.startswith("opt_state") for k in data.files)
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 8


def test_cli_trains_bucket_backend(tmp_path, monkeypatch):
    """`--grid_backend bucket` (the hash gridtype, native level sizes; here
    T=2^12) trains through the CLI: 64 steps on the CPU through the plain
    versions of the hash-encode kernels; the loss falls, the val PSNR
    rises clearly above the untrained field's, the step checkpoint is
    written."""
    monkeypatch.setattr(main_nerf, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))
    ws = str(tmp_path / "ws")
    argv = ARGV + ["--grid_backend", "bucket", "--workspace", ws]
    args = common_parser("t").parse_args(argv)
    val = load_dataset(args, "val", device="cpu")
    cfg = tngp.NGPConfig(bound=1.0, log2_hashmap_size=12, num_levels=4,
                         grid_backend="bucket")
    base = TTrainer(tngp, cfg, build_options(args), build_train_config(args),
                    dataset=val, device="cpu")
    base.init_state()
    psnr0 = base.evaluate(val)

    tr = main_nerf.main(argv)
    assert tr.fcfg.grid == cfg.grid
    assert tr.history[-1]["loss"] < 0.7 * tr.history[0]["loss"], tr.history
    assert tr.eval_history[-1]["psnr"] > psnr0 + 1.5, (psnr0, tr.eval_history)
    assert int(tr.state.step) == 64
    assert os.path.exists(os.path.join(ws, "checkpoints",
                                       "ngp_step0000064.npz"))


def test_unported_options_raise(tmp_path, monkeypatch, capsys):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main_nerf.main(ARGV + ["--gui"])
    # --clip_text without a usable CLIP exits with the JAX CLI's message
    with pytest.raises(SystemExit, match="--clip_random_init"):
        main_nerf.main(ARGV + ["--clip_text", "a chair", "--rand_pose", "0"])
    # bound > 1 (the CLI's default), --dense_render and --error_map are
    # ported: both CLIs (one refusal list) take them
    refuse_unported(common_parser("test").parse_args(ARGV + ["--error_map"]))
    for extra in (["--dense_render"], []):
        argv = ARGV + extra
        if not extra:
            argv = [a for a in ARGV if a not in ("--bound", "1.0")]
        args = common_parser("test").parse_args(argv)
        assert args.bound == (1.0 if extra else 2.0)
        refuse_unported(args)
    # --save_mesh runs: a saved state re-rendered with --test writes the
    # iso-surface of its EMA density at --mesh_resolution
    monkeypatch.setattr(main_nerf, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))
    tr = TTrainer(tngp, tngp.NGPConfig(**SMALL), TOpts(bound=1.0),
                  TCfg(max_steps=100), device="cpu")
    tr.init_state()
    path = tr.save_checkpoint(str(tmp_path / "ngp_step0000000.npz"))
    ws = str(tmp_path / "ws")
    out = main_nerf.main(ARGV + ["--test", "--ckpt", path, "--save_mesh",
                                 "--mesh_resolution", "20", "--workspace",
                                 ws])
    printed = capsys.readouterr().out
    assert out.fcfg.bound == 1.0 and "[mesh]" in printed
    with open(os.path.join(ws, "meshes", "ngp.ply")) as f:
        lines = f.read().splitlines()
    assert lines[:3] == ["ply", "format ascii 1.0", lines[2]]
    assert lines[2].startswith("element vertex ")


def _jax_state_with_moments(seed=0):
    """A JAX full TrainState whose optax state carries nonzero moments and
    counts (as after some steps)."""
    jtr = JTrainer(jngp, jngp.NGPConfig(**SMALL), JOpts(bound=1.0),
                   JCfg(max_steps=100), key=jax.random.PRNGKey(seed))
    st = jtr.init_state()
    rng = np.random.default_rng(seed)
    adam, sched = st.opt_state
    adam = adam._replace(
        count=jnp.int32(7),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(size=a.shape).astype(np.float32)), adam.nu))
    return jtr, st._replace(opt_state=(adam, sched._replace(count=jnp.int32(7))),
                            step=jnp.int32(7))


def test_jax_full_checkpoint_resumes_in_port(tmp_path, capsys):
    """Fault 2: a JAX full checkpoint fills the port's opt_state bit for
    bit (no missing key), and a port step continues from its counts; the
    in-memory conversion gives the same state as the file."""
    _, jst = _jax_state_with_moments()
    path = str(tmp_path / "ngp_step0000007.npz")
    jckpt.save_state(path, jst, full=True)
    ds = TScene().make_dataset(n_views=2, h=16, w=16)
    tr = TTrainer(tngp, tngp.NGPConfig(**SMALL), TOpts(bound=1.0),
                  TCfg(max_steps=100, num_rays=64), dataset=ds, device="cpu")
    tr.init_state()
    capsys.readouterr()
    tr.load_checkpoint(path)
    assert "missing" not in capsys.readouterr().out
    with np.load(path) as data:
        flat = tckpt.flatten_tree(tr.state)
        assert {k for k, _ in flat} == set(data.files)
        for k, v in flat:
            np.testing.assert_array_equal(v.numpy(), data[k], err_msg=k)
        arrays = {k: data[k] for k in data.files}
    mem = tckpt.state_from_arrays(arrays, tr.state)
    for (k, a), (_, b) in zip(flat, tckpt.flatten_tree(mem)):
        assert torch.equal(a, b), k
    tr.train_step()
    assert [int(c) for c in (tr.state.step, tr.state.opt_state[0].count,
                             tr.state.opt_state[1].count)] == [8, 8, 8]


def test_port_checkpoint_loads_into_jax_template(tmp_path, capsys):
    """The port's full checkpoint loads into a JAX TrainState template with
    no missing key and every leaf equal (optax state included)."""
    jtr, jst = _jax_state_with_moments(seed=1)
    tr = TTrainer(tngp, tngp.NGPConfig(**SMALL), TOpts(bound=1.0),
                  TCfg(max_steps=100), device="cpu")
    tr.init_state()
    tr.state = tckpt.state_from_arrays(
        {jckpt._path_str(p): np.asarray(v) for p, v in
         jax.tree_util.tree_flatten_with_path(jst)[0]}, tr.state)
    path = tr.save_checkpoint(str(tmp_path / "port.npz"))
    capsys.readouterr()
    loaded = jckpt.load_state(path, jtr.state)
    assert "missing" not in capsys.readouterr().out
    ref = tckpt.state_to_arrays(tr.state)
    flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert {jckpt._path_str(p) for p, _ in flat} == set(ref)
    for p, v in flat:
        np.testing.assert_array_equal(np.asarray(v), ref[jckpt._path_str(p)])
    assert int(loaded.opt_state[0].count) == 7
