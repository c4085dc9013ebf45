"""Port parity of CCNeRF against the JAX package: the rank-residual field,
`finalize`, `compress`, `compose`, `upsample_model`, `density_loss` (its
gradient at 0 too), the family's optimizer, `.pth` both ways, 96 train
steps side by side and the `main_CCNeRF` CLI with `--compress` and
`--compose` on the CPU. Both packages get the JAX init's params, carried by
path, and the same random numbers (training view, pixels, the dense
sampler's jitter), drawn from the reference's key splits.

Tolerances: fp32 on both sides, only the summation order differs: field
values rtol 1e-5 / atol 1e-6 (composed scenes 1e-4 / 1e-5: their transform
and softmax add roundings); the host surgeries (`finalize`, `compress`) sort
with numpy in both packages and give bit-identical leaves; resizes 1e-5;
optimizer 1e-6 relative over 3 updates; training: the mean loss of each
16-step block within 10%, val PSNR within 0.3 dB.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.models import ccnerf as jcc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu.train.cc_trainer import CCNeRFTrainer as JTrainer
from seal3d_tpu.train.cc_trainer import cc_optimizer as j_cc_optimizer
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu_torch import main_CCNeRF
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ccnerf as tcc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.cc_trainer import CCNeRFTrainer as TTrainer
from seal3d_tpu_torch.train.optim import apply_updates, cc_optimizer
from seal3d_tpu_torch.train.trainer import StepRandom
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# tests/test_ccnerf.py's size
SMALL = dict(resolution=(32, 32, 32), rank_vec_density=(2, 4),
             rank_mat_density=(0, 2), rank_vec=(4, 8), rank_mat=(0, 4),
             degree=2)
STEPS, BLOCK, NUM_RAYS = 96, 16, 256
OPTS = dict(bound=1.0, num_steps=32, upsample_steps=0, min_near=0.05)
PSNR_TOL_DB = 0.3
BLOCK_LOSS_RTOL = 0.10


def _cfgs(**kw):
    kw = dict(SMALL, **kw)
    return jcc.CCNeRFConfig(**kw), tcc.CCNeRFConfig(**kw)


def _jpaths(tree):
    return {jckpt._path_str(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _carry(jp):
    return tckpt.params_from_jax(jax.tree.map(np.asarray, jp))


def _xd(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _same_tree(got, want_tree, exact=True):
    want = _jpaths(want_tree)
    got = dict(tckpt.flatten_tree(got))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        if exact:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-5,
                                       err_msg=k)


def _apply_both(jp, tp, jcfg, tcfg, seed=1, rtol=1e-5, atol=1e-6):
    x, d = _xd(seed=seed)
    js, jc = jcc.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(d))
    ts, tc = tcc.apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=rtol,
                               atol=atol)
    return ts


def test_init_shapes_and_residual_field_match_jax():
    jcfg, tcfg = _cfgs(bg_radius=2.0, bg_resolution=(6, 5), bg_rank=2)
    jp = jcc.init(jax.random.PRNGKey(0), jcfg)
    own = tcc.init(tcfg, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tckpt.flatten_tree(own)} == \
        {k: v.shape for k, v in _jpaths(jp).items()}
    tp = _carry(jp)
    x, d = _xd()
    js, jc = jcc.apply_residual(jp, jcfg, jnp.asarray(x), jnp.asarray(d))
    ts, tc = tcc.apply_residual(tp, tcfg, torch.from_numpy(x),
                                torch.from_numpy(d))
    assert tuple(ts.shape) == (2, 300) and tuple(tc.shape) == (2, 300, 3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    sig = _apply_both(jp, tp, jcfg, tcfg, seed=0)
    np.testing.assert_allclose(sig.numpy(), ts[-1].numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        tcc.density(tp, tcfg, torch.from_numpy(x))["sigma"].numpy(),
        np.asarray(jcc.density(jp, jcfg, jnp.asarray(x))["sigma"]),
        rtol=1e-5, atol=1e-6)
    sph = np.random.default_rng(3).uniform(-1, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tcc.background(tp, tcfg, torch.from_numpy(sph[:, :2]),
                       torch.from_numpy(d[:50])).numpy(),
        np.asarray(jcc.background(jp, jcfg, jnp.asarray(sph[:, :2]),
                                  jnp.asarray(d[:50]))), rtol=1e-5, atol=1e-6)


def test_finalize_and_compress_match_jax():
    jcfg, tcfg = _cfgs()
    jp = jcc.init(jax.random.PRNGKey(1), jcfg)
    tp = _carry(jp)
    jf, tf = jcc.finalize(jp), tcc.finalize(tp)
    _same_tree(tf, jf)
    assert len(tf["objects"][0]["vec_density"]) == 1
    _apply_both(jf, tf, jcfg, tcfg, seed=2)
    for ranks in ((4, 2, 8, 4), (2, 1, 4, 2), (3, 0, 5, 1)):
        jcp, tcp = jcc.compress(jp, ranks), tcc.compress(tp, ranks)
        _same_tree(tcp, jcp)
        _apply_both(jcp, tcp, jcfg, tcfg, seed=3)
    # full ranks keep the field
    full = tcc.compress(tp, (4, 2, 8, 4))
    np.testing.assert_allclose(
        tcc.apply(full, tcfg, *map(torch.from_numpy, _xd(seed=4)))[0].numpy(),
        tcc.apply(tp, tcfg, *map(torch.from_numpy, _xd(seed=4)))[0].numpy(),
        rtol=1e-4, atol=1e-6)


def test_compose_matches_jax():
    jcfg, tcfg = _cfgs()
    ja = jcc.init(jax.random.PRNGKey(5), jcfg)
    jb = jcc.init(jax.random.PRNGKey(6), jcfg)
    ang = 0.3
    rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.array([0.3, 0.0, -0.1], np.float32)
    kw = dict(R=rot, s=1.2, t=t)
    js = jcc.compose(jcc.compose(ja, jb, t=t), jb, **kw)
    ts = tcc.compose(tcc.compose(_carry(ja), _carry(jb), t=t), _carry(jb),
                     **kw)
    assert len(ts["objects"]) == 3
    _same_tree(ts, js, exact=False)
    _apply_both(js, ts, jcfg, tcfg, seed=7, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("res", [(48, 40, 36), (20, 24, 16)])
def test_upsample_model_matches_jax(res):
    jcfg, tcfg = _cfgs()
    jp = jcc.init(jax.random.PRNGKey(8), jcfg)
    _same_tree(tcc.upsample_model(_carry(jp), tcfg, res),
               jcc.upsample_model(jp, jcfg, res), exact=False)


def test_density_loss_and_its_gradient_at_zero():
    jcfg, tcfg = _cfgs()
    jp = jcc.init(jax.random.PRNGKey(9), jcfg)
    # zeros in a factor: jnp.abs's gradient is +1 there
    u = jp["objects"][0]["vec_density"][0]["U"][0]
    jp["objects"][0]["vec_density"][0]["U"][0] = u.at[:, :5].set(0.0)
    tp = _carry(jp)
    jl = jcc.density_loss(jp, jcfg)
    leaves = dict(tckpt.flatten_tree(tp))
    req = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    tl = tcc.density_loss(tckpt.map_tree(tp, lambda k, _: req[k]), tcfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    jg = _jpaths(jax.grad(lambda p: jcc.density_loss(p, jcfg))(jp))
    tg = dict(zip(req, torch.autograd.grad(tl, list(req.values()),
                                           allow_unused=True)))
    for k, v in jg.items():
        got = tg[k]
        got = np.zeros_like(v) if got is None else got.numpy()
        np.testing.assert_allclose(got, v, rtol=1e-6, atol=0, err_msg=k)
    zero_grad = jg["objects/0/vec_density/0/U/0"][:, :5]
    assert (zero_grad > 0).all()


def test_cc_optimizer_matches_jax():
    jcfg, tcfg = _cfgs(bg_radius=2.0, bg_resolution=(6, 5), bg_rank=2)
    jp = jcc.init(jax.random.PRNGKey(2), jcfg)
    tp = _carry(jp)
    jo, to = j_cc_optimizer(JCfg(max_steps=10)), cc_optimizer(10)
    js, ts = jo.init(jp), to.init(tp)
    assert set(_jpaths(js)) == {k for k, _ in tckpt.flatten_tree(ts)}
    assert ("inner_states/factor/inner_state/0/mu/objects/0/mat_color/0/U/1"
            in _jpaths(js))
    rng = np.random.default_rng(2)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, jp))
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update(tckpt.params_from_jax(g), ts)
        tp = apply_updates(tp, tu)
        for name, want, got in (("updates", ju, tu), ("state", js, ts),
                                ("params", jp, tp)):
            got = dict(tckpt.flatten_tree(got))
            for k, v in _jpaths(want).items():
                np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6,
                                           atol=1e-9,
                                           err_msg=f"{step} {name} {k}")
    obj = tu["objects"][0]
    assert not obj["aabb"].any() and not obj["T"].any() and not obj["R"].any()


def test_pth_both_ways(tmp_path):
    jcfg, tcfg = _cfgs()
    jp = jcc.upsample_model(jcc.init(jax.random.PRNGKey(3), jcfg), jcfg,
                            (20, 18, 22))
    jp["objects"][0]["aabb"] = jnp.asarray([-0.7, -0.6, -0.8, 0.75, 0.65,
                                            0.6], jnp.float32)
    tp = _carry(jp)
    path = str(tmp_path / "port.pth")
    tckpt.export_torch_ccnerf(path, tp, tcfg, step=5)
    got, new_cfg = jckpt.import_torch_ccnerf(path, jcfg)
    assert new_cfg.resolution == (20, 18, 22)
    assert new_cfg.rank_mat == jcfg.rank_mat
    _same_tree(_carry(got), jp)

    path = str(tmp_path / "jax.pth")
    jckpt.export_torch_ccnerf(path, jp, jcfg, step=5)
    got, new_cfg = tckpt.import_torch_ccnerf(path, tcfg)
    assert new_cfg.resolution == (20, 18, 22)
    _same_tree(got, jp)
    # compressed params carry their own ranks, and the trainer re-builds at
    # the file's structure
    small = tcc.compress(tp, (2, 1, 4, 2))
    path = str(tmp_path / "small.pth")
    tckpt.export_torch_ccnerf(path, small, tcfg)
    tr = TTrainer(tcfg, TOpts(**OPTS), TCfg(), device="cpu")
    tr.load_checkpoint(path)
    assert tr.fcfg.rank_vec == (4,) and tr.fcfg.resolution == (20, 18, 22)
    _same_tree(tr.state.params, jcc.compress(jp, (2, 1, 4, 2)))
    _apply_both(jcc.compress(jp, (2, 1, 4, 2)), tr.state.ema_params, jcfg,
                tr.fcfg)


# ----------------------------------------------------------- training run

def _to_port(ds):
    return NeRFDataset(poses=ds.poses, images=ds.images,
                       intrinsics=ds.intrinsics, h=ds.h, w=ds.w)


def test_training_side_by_side():
    train = JScene().make_dataset(n_views=8, h=24, w=24, seed=0)
    val = JScene().make_dataset(n_views=2, h=24, w=24, seed=1)
    jcfg, tcfg = _cfgs(resolution=(48, 48, 48))
    cfg = dict(num_rays=NUM_RAYS, max_steps=STEPS, eval_chunk=1024)
    jtr = JTrainer(jcfg, JOpts(**OPTS), JCfg(**cfg), dataset=train,
                   key=jax.random.PRNGKey(0))
    jtr.init_state()
    ttr = TTrainer(tcfg, TOpts(**OPTS), TCfg(**cfg), dataset=_to_port(train),
                   device="cpu")
    ttr.init_state()
    params = _carry(jtr.state.params)
    ttr.state = ttr.state._replace(
        params=params, ema_params=jax.tree.map(torch.clone, params),
        opt_state=ttr.optimizer.init(params))
    p0 = ttr.evaluate(_to_port(val))
    key = jax.random.PRNGKey(7)
    jlosses, tlosses = [], []
    for _ in range(STEPS):
        key, kstep = jax.random.split(key)
        kimg, kray, _, kjit = jax.random.split(kstep, 4)
        img_idx = jax.random.randint(kimg, (), 0, len(train))
        rays = j_get_rays(kray, jnp.asarray(train.poses)[img_idx],
                          jnp.asarray(train.intrinsics), train.h, train.w,
                          NUM_RAYS)
        rand = StepRandom(
            img_idx=torch.tensor(int(img_idx)),
            inds=torch.from_numpy(np.array(rays["inds"])).long(), bg=None,
            jitter=None, z_jitter=torch.from_numpy(np.array(
                jax.random.uniform(kjit, (NUM_RAYS, OPTS["num_steps"])))))
        jtr.state, jm = jtr._train_step(jtr.state, kstep)
        tm = ttr.train_step(rand)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
    jpsnr = jtr.evaluate(val)
    tpsnr = ttr.evaluate(_to_port(val))
    jb = np.array(jlosses).reshape(-1, BLOCK).mean(1)
    tb = np.array(tlosses).reshape(-1, BLOCK).mean(1)
    print(f"\n[ccnerf parity] val PSNR untrained {p0:.3f} dB, reference "
          f"{jpsnr:.3f}, port {tpsnr:.3f}; block losses reference "
          f"{np.round(jb, 5)}, port {np.round(tb, 5)}")
    assert jb[-1] < 0.5 * jb[0] and tb[-1] < 0.5 * tb[0], (jb, tb)
    np.testing.assert_allclose(tb, jb, rtol=BLOCK_LOSS_RTOL)
    assert abs(tpsnr - jpsnr) <= PSNR_TOL_DB, (jpsnr, tpsnr)
    assert tpsnr > p0 + 2.0


# -------------------------------------------------------------------- CLI

_TINY = ["--iters", "40", "--num_rays", "128", "--H", "24", "--W", "24",
         "--bound", "1.0", "--num_steps", "24", "--upsample_steps", "0",
         "--min_near", "0.05", "--num_views", "3", "--device", "cpu",
         "--rank_vec_density", "2", "4", "--rank_mat_density", "0", "2",
         "--rank_vec", "4", "8", "--rank_mat", "0", "4"]


def test_main_ccnerf_cli_on_cpu(tmp_path):
    """Train, then `--test --compress` and `--compose` on the run's own
    checkpoint: the compressed ranks, a two-object scene, finite renders."""
    ws = str(tmp_path / "ws")
    tr = main_CCNeRF.main(["synthetic", "--workspace", ws, *_TINY])
    ckpt = os.path.join(ws, "checkpoints", "ccnerf_step0000040.npz")
    assert os.path.exists(ckpt) and np.isfinite(tr.eval_history[-1]["psnr"])
    with np.load(ckpt) as f:
        assert "params/objects/0/mat_color/0/U/2" in f.files
        assert ("opt_state/inner_states/net/inner_state/0/mu/objects/0/"
                "vec_color/1/S") in f.files
    tr = main_CCNeRF.main(["synthetic", "--workspace", ws, *_TINY, "--test",
                           "--compress", "2", "1", "4", "2"])
    obj = tr.state.params["objects"][0]
    assert [g["S"].shape[1] for g in obj["vec_color"]] == [4]
    assert [g["S"].shape[1] for g in obj["mat_density"]] == [1]
    tr = main_CCNeRF.main(["synthetic", "--workspace", ws, *_TINY, "--test",
                           "--compose", ckpt])
    assert len(tr.state.params["objects"]) == 2
    assert all(s["nonfinite"] == 0 for s in tr.render_stats)
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 8
    # the reference has no viewer for this CLI (it ignores --gui)
    with pytest.raises(ValueError, match="no viewer"):
        main_CCNeRF.main(["synthetic", "--device", "cpu", "--gui"])
