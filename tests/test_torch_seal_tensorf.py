"""Seal-3D editing on a TensoRF field, port against the JAX package: the
pretraining moves every leaf but `aabb` (the family's rule, where NGP moves
its hash tables only), its losses over 6 epochs, the finetune's one Adam
over every leaf moving `aabb` as the JAX package's does (a quirk of the
reference, mirrored: the field normalises by `params["aabb"]`, which gets a
gradient, and the student's optimizer does not freeze it), the
`main_SealTensoRF` CLI on the CPU, and the refusal of a `.pth` teacher.

Both students start from the same teacher params (JAX init) with the
analytic scene's occupancy as the teacher bitfield, as
tests/test_torch_seal.py sets up NGP's. Pretrain losses within 1e-3 (fp32
on both sides; the colour MLP's bf16 rounding, a different summation order);
the finetune's `aabb` within 1e-6 after 3 steps on the same rays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.models import tensorf as jtf
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.seal import mappers as jmap
from seal3d_tpu.seal import trainer as jst
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu_torch import main_SealTensoRF
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import tensorf as ttf
from seal3d_tpu_torch.render import occupancy as tocc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.seal import mappers as tmap
from seal3d_tpu_torch.seal import trainer as tst
from seal3d_tpu_torch.seal.renderer import make_teacher_field
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.optim import Optimizer
from seal3d_tpu_torch.train.trainer import StepRandom
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from test_torch_seal import EDIT, OPTS, TCFG


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TF_KW = dict(resolution=(20, 20, 20), sigma_rank=(2, 2, 2),
             color_rank=(3, 3, 3), hidden_dim=16)
PRETRAIN = dict(epochs=6, batch_size=4096, lr=0.05, local_point_step=0.05,
                local_angle_step=90, surrounding_point_step=0.1,
                global_point_step=0.3)
PRETRAIN_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def students():
    """A JAX and a port SealTrainer on TensoRF over the same teacher params,
    the analytic occupancy as the teacher bitfield, two 24x24 views; both
    pretrained 6 epochs -> (js, ts, teacher params, ds, JAX losses, port
    losses)."""
    ds = JScene().make_dataset(n_views=2, h=24, w=24, seed=0)
    occ = jocc.occupancy_update(jocc.occupancy_init(cascades=1),
                                JScene().density, jax.random.PRNGKey(2),
                                bound=1.0, density_thresh=0.01, full=True)
    jcfg, tcfg = jtf.TensoRFConfig(**TF_KW), ttf.TensoRFConfig(**TF_KW)
    p = jtf.init(jax.random.PRNGKey(0), jcfg)
    js = jst.SealTrainer(jtf, jcfg, JOpts(**OPTS), JCfg(**TCFG),
                         jmap.build_mapper(EDIT), teacher_params=p,
                         teacher_bitfield=occ.bitfield, dataset=ds,
                         key=jax.random.PRNGKey(1))
    js.init_state()
    js.state = js.state._replace(params=jax.tree.map(jnp.copy, p),
                                 ema_params=jax.tree.map(jnp.copy, p))
    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, p))
    ts = tst.SealTrainer(ttf, tcfg, TOpts(**OPTS), TCfg(**TCFG),
                         tmap.build_mapper(EDIT), teacher_params=tp,
                         teacher_bitfield=_t(occ.bitfield), dataset=tds,
                         device="cpu")
    ts.init_state()
    ts.state = ts.state._replace(
        params=tckpt.params_from_jax(jax.tree.map(np.asarray, p)),
        ema_params=tckpt.params_from_jax(jax.tree.map(np.asarray, p)))
    js.init_pretraining(jst.PretrainConfig(**PRETRAIN))
    ts.init_pretraining(tst.PretrainConfig(**PRETRAIN))
    jl = js.pretrain_epochs(PRETRAIN["epochs"])
    tl = ts.pretrain_epochs(PRETRAIN["epochs"])
    return js, ts, tp, ds, occ, np.asarray(jl), np.asarray(tl)


def test_pretraining_moves_every_leaf_but_aabb(students):
    js, ts, tp, *_ = students
    moved = dict(tckpt.flatten_tree(ts.state.params))
    for k, v in tckpt.flatten_tree(tp):
        if k == "aabb":
            assert torch.equal(moved[k], v)
            np.testing.assert_array_equal(np.asarray(js.state.params["aabb"]),
                                          v.numpy())
        else:   # factors, basis_mat and the colour net all move
            assert (moved[k] - v).abs().max() > 1e-4, k
    # the pretraining optimizer holds exactly those leaves
    held = {k.split("/", 2)[-1] for k, _ in
            tckpt.flatten_tree(ts._pre_opt_state) if "/mu/" in k}
    assert held == {k for k, _ in tckpt.flatten_tree(tp) if k != "aabb"}
    # NGP keeps its rule: the hash tables only
    ngp_like = {"encoder": 1, "encoder_color": 2, "sigma_net": 3,
                "color_net": 4}
    assert set(tst._pretrain_leaves(ngp_like)) == {"encoder", "encoder_color"}


def test_pretraining_losses_match_jax(students):
    *_, jl, tl = students
    print(f"\n[seal tensorf] pretrain losses reference {np.round(jl, 5)}, "
          f"port {np.round(tl, 5)}")
    assert tl.shape == jl.shape == (PRETRAIN["epochs"],)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=PRETRAIN_TOL)
    assert tl[-1] < tl[0]


def test_teacher_field_exposes_background():
    edit = tmap.build_mapper(EDIT)
    assert make_teacher_field(ttf, edit, None).background is ttf.background
    # NGP has its background net too (bg_radius > 0), as in the JAX package
    from seal3d_tpu_torch.models import ngp as tngp
    assert make_teacher_field(tngp, edit, None).background is tngp.background


def test_finetune_moves_aabb_as_jax_does(students):
    """Three finetune steps of each student (its base optimizer over every
    leaf) on the same rays and jitter, from the same params and the
    analytic occupancy: `aabb` moves, by the same amount in both."""
    js, ts, _, ds, occ, *_ = students
    assert type(ts.optimizer) is Optimizer
    params = tckpt.params_from_jax(jax.tree.map(np.asarray, js.state.params))
    ts.state = ts.state._replace(
        params=params, opt_state=ts.optimizer.init(params),
        occ=tocc.OccupancyState(*[_t(a) for a in occ]))
    # the JAX step donates its state: hand it copies
    js.state = js.state._replace(opt_state=js.optimizer.init(js.state.params),
                                 occ=jax.tree.map(jnp.copy, occ))
    start = np.array(js.state.params["aabb"])
    key = jax.random.PRNGKey(9)
    n = TCFG["num_rays"]
    for _ in range(3):
        key, kstep = jax.random.split(key)
        kimg, kray, _, kjit = jax.random.split(kstep, 4)
        img_idx = jax.random.randint(kimg, (), 0, len(ds))
        rays = j_get_rays(kray, jnp.asarray(ds.poses)[img_idx],
                          jnp.asarray(ds.intrinsics), ds.h, ds.w, n)
        js.state, _ = js._train_step(js.state, kstep)
        ts.train_step(StepRandom(
            img_idx=torch.tensor(int(img_idx)),
            inds=torch.from_numpy(np.array(rays["inds"])).long(), bg=None,
            jitter=torch.from_numpy(np.array(jax.random.uniform(kjit, (n,))))))
    jab = np.asarray(js.state.params["aabb"])
    tab = ts.state.params["aabb"].numpy()
    print(f"\n[seal tensorf] student aabb after 3 finetune steps: reference "
          f"{jab}, port {tab}")
    assert np.abs(jab - start).max() > 1e-3
    np.testing.assert_allclose(tab, jab, rtol=0, atol=1e-6)


_CLI = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0",
        "--min_near", "0.05", "--max_steps", "512", "--H", "24", "--W", "24",
        "--num_rays", "256", "--device", "cpu", "--resolution0", "16",
        "--seal_config", "seal_config_bbox", "--pretraining_epochs", "2",
        "--pretraining_batch_size", "8192",
        "--pretraining_local_point_step", "0.04",
        "--pretraining_surrounding_point_step", "0.08",
        "--pretraining_global_point_step", "0.2", "--extra_epochs", "8",
        "--num_views", "4"]


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_seal_tensorf_cli_on_cpu(tmp_path, monkeypatch):
    """A tiny bbox edit through the CLI on a teacher `.npz` whose factors
    were upsampled past `--resolution0` (the teacher loads at the file's
    shapes; its grid is empty, so the proxies hold the force-filled edit
    region only): the run's files and the edited test views; the student
    ends at the teacher's shapes."""
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer

    monkeypatch.chdir(_repo_root())
    ws, tws = str(tmp_path / "ws"), str(tmp_path / "teacher")
    teacher = TensoRFTrainer(
        ttf.TensoRFConfig(resolution=(16,) * 3), TOpts(**OPTS),
        TCfg(workspace=tws), dataset=SyntheticScene().make_dataset(
            n_views=2, h=24, w=24), device="cpu", upsample_steps=(),
        shrink_step=None, name="sealtensorf_teacher")
    teacher.init_state()
    teacher.state = teacher.state._replace(params=ttf.upsample_model(
        teacher.state.params, teacher.fcfg, (20, 20, 20)))
    path = teacher.save_checkpoint()
    student = main_SealTensoRF.main(
        [*_CLI, "--teacher_ckpt", path, "--workspace", ws])
    for f in ("timer.json", "seal.json", "options.json", "run.sh"):
        assert os.path.exists(os.path.join(ws, f)), f
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 8
    assert student.fcfg.decomposition == "vm"
    assert student.state.params["sigma_vec"][0].shape == (16, 20)
    # the TensoRF CLI's own pretraining rate (main_SealNeRF's is 0.05)
    assert student.pcfg.lr == main_SealTensoRF.SEAL_TENSORF_PRETRAINING_LR


def test_pth_teacher_raises_named_error(tmp_path, monkeypatch):
    monkeypatch.chdir(_repo_root())
    cfg = ttf.TensoRFConfig(resolution=(16,) * 3, sigma_rank=(2, 2, 2),
                            color_rank=(3, 3, 3))
    path = str(tmp_path / "teacher.pth")
    tckpt.export_torch_tensorf(path, ttf.init(cfg))
    with pytest.raises(ValueError, match=r"\.pth teacher is read as NGP"):
        main_SealTensoRF.main([*_CLI, "--teacher_ckpt", path,
                               "--workspace", str(tmp_path / "ws")])
