"""Port parity of TensoRF training and its checkpoints against the JAX
package: the grouped optimizer (`tensorf_optimizer`), `.npz` states both
ways (one written after an upsample and a shrink among them), reference
`.pth` files both ways, a side-by-side training run through an upsample and
a shrink, and the `main_tensoRF` CLI on the CPU.

The training run gives both packages the same initial params and every
random number of the run (training view, pixels, march jitter, the jittered
cells of each grid update), as tests/test_torch_train_parity.py does for
NGP: 96 steps of a tiny VM field (resolution 16 -> 24, ranks 2 and 4,
hidden 16), 256 rays, 24x24 views, an upsample at step 32 and the shrink at
step 64. Before the shrink both packages get the scene's analytic density
grid (a 64-step field still holds the init's fog, sigma ~1, in the box's
corners, so its own grid would cut nothing); the grid updates go on from
it. Tolerances: factor shapes and `aabb` equal after each milestone;
the mean loss of each 16-step block within 10%; val PSNR within 0.3 dB.
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
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.models import tensorf as jtf
from seal3d_tpu.ops.bitfield import GRID_CELLS
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu.train.tensorf_trainer import TensoRFTrainer as JTrainer
from seal3d_tpu.train.tensorf_trainer import tensorf_optimizer as j_opt
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu_torch import main_tensoRF
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import tensorf as ttf
from seal3d_tpu_torch.render import occupancy as tocc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.optim import apply_updates
from seal3d_tpu_torch.train.optim import tensorf_optimizer as t_opt
from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer as TTrainer
from seal3d_tpu_torch.train.trainer import StepRandom
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from test_torch_tensorf import _density_grid, _jpaths
from test_torch_train_step import NUM_RAYS, OPTS


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = dict(resolution=(16, 16, 16), sigma_rank=(2, 2, 2),
            color_rank=(4, 4, 4), hidden_dim=16)
STEPS, BLOCK, FULL_UPDATES = 96, 16, 2
UPSAMPLE, SHRINK = (32,), 64
PARTIAL_CELLS, OCC_CELLS = GRID_CELLS // 8, 2**16   # occupancy_update's
PSNR_TOL_DB = 0.3
BLOCK_LOSS_RTOL = 0.10


def _cfgs(decomposition="vm", **kw):
    kw = dict(TINY, decomposition=decomposition, **kw)
    if decomposition == "cp":
        kw.update(sigma_rank=(3, 3, 3), color_rank=(4, 4, 4))
    return jtf.TensoRFConfig(**kw), ttf.TensoRFConfig(**kw)


def _to_port(ds):
    return NeRFDataset(poses=ds.poses, images=ds.images,
                       intrinsics=ds.intrinsics, h=ds.h, w=ds.w)


def _trainers(jcfg, tcfg, train, **kw):
    # one 1024-ray eval chunk holds a 24x24 view
    cfg = dict(num_rays=NUM_RAYS, max_steps=STEPS, eval_chunk=1024)
    kw = dict(dict(upsample_steps=UPSAMPLE, n_voxel_init=16**3,
                   n_voxel_final=24**3, shrink_step=SHRINK), **kw)
    jtr = JTrainer(jcfg, JOpts(**OPTS), JCfg(**cfg), dataset=train,
                   key=jax.random.PRNGKey(0), **kw)
    jtr.init_state()
    ttr = TTrainer(tcfg, TOpts(**OPTS), TCfg(**cfg), dataset=_to_port(train),
                   device="cpu", **kw)
    ttr.init_state()
    return jtr, ttr


def _carry_params(jtr, ttr):
    params = tckpt.params_from_jax(jax.tree.map(np.asarray, jtr.state.params))
    ttr.state = ttr.state._replace(
        params=params, ema_params=jax.tree.map(torch.clone, params),
        opt_state=ttr.optimizer.init(params))


@pytest.fixture(scope="module")
def scene():
    train = JScene().make_dataset(n_views=8, h=24, w=24, seed=0)
    val = JScene().make_dataset(n_views=2, h=24, w=24, seed=1)
    return train, val


# ------------------------------------------------------------- optimizer

def test_grouped_optimizer_matches_tensorf_optimizer():
    jcfg, tcfg = _cfgs(bg_radius=2.0, bg_resolution=(6, 5), bg_rank=2,
                       hidden_dim_bg=8)
    jp = jtf.init(jax.random.PRNGKey(1), jcfg)
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    jo, to = j_opt(JCfg(max_steps=10)), t_opt(10)
    js, ts = jo.init(jp), to.init(tp)
    want_keys = set(_jpaths(js))
    assert want_keys == {k for k, _ in tckpt.flatten_tree(ts)}
    assert "inner_states/factor/inner_state/0/mu/sigma_mat/0" in want_keys
    assert not any("aabb" in k or "frozen" in k for k in want_keys)
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
                np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                           atol=1e-6,
                                           err_msg=f"step {step} {name} {k}")
        assert np.array_equal(np.asarray(jp["aabb"]), tp["aabb"].numpy())
        assert not tu["aabb"].any()


# ------------------------------------------------------------ checkpoints

def _resized_jax_state(jtr):
    """The JAX trainer's state after its shrink (on `_density_grid`) and an
    upsample, with every optimizer leaf filled with noise."""
    grid = _density_grid(11)
    occ = jtr.state.occ._replace(density_grid=jnp.asarray(grid),
                                 mean_density=jnp.float32(grid.mean()))
    jtr.state = jtr.state._replace(occ=occ)
    jtr.maybe_resize(SHRINK)
    jtr.maybe_resize(UPSAMPLE[0])
    rng = np.random.default_rng(3)
    jtr.state = jtr.state._replace(opt_state=jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(a.dtype))
        if a.dtype == jnp.float32 else a + 5, jtr.state.opt_state))
    return jtr.state


def test_npz_after_upsample_and_shrink_both_ways(scene, tmp_path):
    jcfg, tcfg = _cfgs()
    jtr, ttr = _trainers(jcfg, tcfg, scene[0])
    jst = _resized_jax_state(jtr)
    assert jst.params["sigma_vec"][0].shape != (2, 16)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jst)
    ttr.load_checkpoint(path)
    with np.load(path) as data:
        want = {k: data[k] for k in data.files}
    got = tckpt.state_to_arrays(ttr.state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the loaded state trains on at its shapes
    ttr.train_step()
    assert int(ttr.state.step) == int(jst.step) + 1

    back = str(tmp_path / "port.npz")
    tckpt.save_state(back, ttr.state)
    jtr2 = JTrainer(jcfg, JOpts(**OPTS), JCfg(num_rays=NUM_RAYS),
                    key=jax.random.PRNGKey(5))
    jtr2.init_state()
    loaded = _jpaths(jtr2.load_checkpoint(back))
    mine = tckpt.state_to_arrays(ttr.state)
    assert set(loaded) == set(mine)
    for k in mine:
        np.testing.assert_array_equal(loaded[k], mine[k], err_msg=k)


def test_ngp_load_keeps_its_shape_check(tmp_path):
    cfg = jngp.NGPConfig(log2_hashmap_size=12, num_levels=4)
    jp = jngp.init(jax.random.PRNGKey(0), cfg)
    arrays = {f"params/{k}": v for k, v in _jpaths(jp).items()}
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    arrays["params/encoder"] = arrays["params/encoder"][:-1]
    with pytest.raises(ValueError, match="shape"):
        tckpt.state_from_arrays(arrays, {"params": tp})
    got = tckpt.state_from_arrays(arrays, {"params": tp}, take_shapes=True)
    assert got["params"]["encoder"].shape[0] == tp["encoder"].shape[0] - 1


@pytest.mark.parametrize("decomposition", ["vm", "cp"])
def test_pth_both_ways(decomposition, tmp_path):
    jcfg, tcfg = _cfgs(decomposition, bg_radius=2.0, bg_resolution=(6, 5),
                       bg_rank=2, hidden_dim_bg=8)
    jp = jtf.upsample_model(jtf.init(jax.random.PRNGKey(2), jcfg), jcfg,
                            (20, 18, 22))
    jp["aabb"] = jnp.asarray([-0.7, -0.6, -0.8, 0.75, 0.65, 0.6], jnp.float32)
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    want = _jpaths(jp)

    path = str(tmp_path / "port.pth")
    tckpt.export_torch_tensorf(path, tp, step=12)
    got, res = jckpt.import_torch_tensorf(path, jcfg)
    assert res == [20, 18, 22] == tckpt.tensorf_resolution(tp)
    assert _jpaths(got).keys() == want.keys()
    for k, v in _jpaths(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    path = str(tmp_path / "jax.pth")
    jckpt.export_torch_tensorf(path, jp, step=12)
    got, res = tckpt.import_torch_tensorf(path, tcfg)
    assert res == [20, 18, 22]
    got = dict(tckpt.flatten_tree(got))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    # through the trainer: params re-instantiated at the file's resolution
    tr = TTrainer(tcfg, TOpts(**OPTS), TCfg(), device="cpu",
                  upsample_steps=(), shrink_step=None)
    tr.load_checkpoint(path)
    assert tckpt.tensorf_resolution(tr.state.params) == [20, 18, 22]
    assert torch.equal(tr.state.ema_params["aabb"], tr.state.params["aabb"])

    other = "cp" if decomposition == "vm" else "vm"
    with pytest.raises(ValueError, match="decomposition"):
        tckpt.import_torch_tensorf(path, _cfgs(other)[1])


# ----------------------------------------------------------- training run

def _install_scene_grid(jtr, ttr):
    """Both trainers' density grid, bitfield, mean density and occupied
    AABB replaced by those of the scene's analytic density."""
    occ = jocc.occupancy_update(jocc.occupancy_init(cascades=1),
                                JScene().density, jax.random.PRNGKey(2),
                                bound=1.0, density_thresh=0.01, full=True)
    keys = ("density_grid", "bitfield", "mean_density", "occ_aabb")
    new = {k: getattr(occ, k) for k in keys}
    jtr.state = jtr.state._replace(occ=jtr.state.occ._replace(**new))
    ttr.state = ttr.state._replace(occ=ttr.state.occ._replace(
        **{k: torch.from_numpy(np.array(v)) for k, v in new.items()}))


def test_training_side_by_side_through_upsample_and_shrink(scene):
    train, val = scene
    jcfg, tcfg = _cfgs()
    jtr, ttr = _trainers(jcfg, tcfg, train)
    _carry_params(jtr, ttr)
    np.testing.assert_array_equal(ttr.state.occ.density_grid.numpy(),
                                  np.asarray(jtr.state.occ.density_grid))

    def density_fn(x):
        return ttr.field.density(ttr.state.params, ttr.fcfg,
                                 x)["sigma"] * ttr.opts.density_scale

    key = jax.random.PRNGKey(7)
    jlosses, tlosses, shapes = [], [], []
    for i in range(STEPS):
        if i == SHRINK:
            _install_scene_grid(jtr, ttr)
        if i in (*UPSAMPLE, SHRINK):
            jtr.maybe_resize(i)
            ttr.maybe_resize(i)
            jl = {k: v.shape for k, v in _jpaths(jtr.state.params).items()}
            tl = {k: tuple(v.shape)
                  for k, v in tckpt.flatten_tree(ttr.state.params)}
            assert tl == jl, (i, tl, jl)
            np.testing.assert_array_equal(ttr.state.params["aabb"].numpy(),
                                          np.asarray(jtr.state.params["aabb"]))
            shapes.append((i, tl["sigma_vec/0"], ttr.state.params["aabb"]))
        key, kgrid, kstep = jax.random.split(key, 3)
        if i % BLOCK == 0:
            full = i // BLOCK < FULL_UPDATES
            if full:
                jtr.state = jtr._update_grid_full(jtr.state, kgrid)
                _, kcell = jax.random.split(kgrid)
                uniforms, n_cells = None, GRID_CELLS
            else:
                jtr.state = jtr._update_grid_partial(jtr.state, kgrid)
                _, kocc, kcell = jax.random.split(kgrid, 3)
                uniforms = torch.from_numpy(np.array(
                    jax.random.uniform(kocc, (OCC_CELLS,)))[None])
                n_cells = PARTIAL_CELLS + OCC_CELLS
            jitter = np.array(jax.random.uniform(kcell, (n_cells, 3)))[None]
            with torch.no_grad():
                occ = tocc.occupancy_update(
                    ttr.state.occ, density_fn, 1.0,
                    density_thresh=ttr.cfg.density_thresh, full=full,
                    jitter=torch.from_numpy(jitter), uniforms=uniforms)
            ttr.state = ttr.state._replace(occ=occ)
        kimg, kray, _, kjit = jax.random.split(kstep, 4)
        img_idx = jax.random.randint(kimg, (), 0, len(train))
        rays = j_get_rays(kray, jnp.asarray(train.poses)[img_idx],
                          jnp.asarray(train.intrinsics), train.h, train.w,
                          NUM_RAYS)
        rand = StepRandom(
            img_idx=torch.tensor(int(img_idx)),
            inds=torch.from_numpy(np.array(rays["inds"])).long(), bg=None,
            jitter=torch.from_numpy(np.array(
                jax.random.uniform(kjit, (NUM_RAYS,)))))
        jtr.state, jm = jtr._train_step(jtr.state, kstep)
        tm = ttr.train_step(rand)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
    assert ttr.l1_weight == jtr._l1["w"] == 0.0
    jpsnr = jtr.evaluate(val)
    tpsnr = ttr.evaluate(_to_port(val))
    jb = np.array(jlosses).reshape(-1, BLOCK).mean(1)
    tb = np.array(tlosses).reshape(-1, BLOCK).mean(1)
    print(f"\n[tensorf parity] val PSNR reference {jpsnr:.3f} dB, port "
          f"{tpsnr:.3f} dB; block losses reference {np.round(jb, 5)}, port "
          f"{np.round(tb, 5)}; milestones {shapes}")
    assert jb[-1] < 0.5 * jb[0] and tb[-1] < 0.5 * tb[0], (jb, tb)
    np.testing.assert_allclose(tb, jb, rtol=BLOCK_LOSS_RTOL)
    assert abs(tpsnr - jpsnr) <= PSNR_TOL_DB, (jpsnr, tpsnr)
    # the shrink cut the box
    assert (np.abs(ttr.state.params["aabb"].numpy()) < 1.0).any()


# -------------------------------------------------------------------- CLI

_TINY = ["--iters", "50", "--num_rays", "128", "--H", "32", "--W", "32",
         "--bound", "1.0", "--dense_render", "--num_steps", "24",
         "--upsample_steps", "0", "--min_near", "0.05",
         "--eval_interval", "1000", "--num_views", "3"]


def test_main_tensorf_cli_on_cpu(tmp_path):
    """tests/test_cli.py's tiny size through the port's CLI, with one
    upsample (32^3 -> 40^3 at step 25): a step checkpoint at the new
    shapes and the test renders."""
    ws = str(tmp_path / "ws")
    tr = main_tensoRF.main(["synthetic", "--device", "cpu", "--workspace", ws,
                            *_TINY, "--resolution0", "32", "--resolution1",
                            "40", "--upsample_model_steps", "25"])
    assert tckpt.tensorf_resolution(tr.state.params) == [40, 40, 40]
    ckpts = os.listdir(os.path.join(ws, "checkpoints"))
    assert "tensorf_step0000050.npz" in ckpts
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 8
    assert np.isfinite(tr.eval_history[-1]["psnr"])


@pytest.mark.parametrize("flag,item", [("--gui", "Other backends and families"),
                                       ("--error_map", "Train step")])
def test_main_tensorf_refuses_unported_options(flag, item, tmp_path):
    """--gui is refused, naming its ROADMAP.md item. --error_map, refused
    while the item 'Train step' was open, is ported: the tiny CLI run with
    it keeps a per-view error map, refreshed by the steps, in its state and
    its checkpoint."""
    if flag == "--gui":
        with pytest.raises(NotImplementedError, match=item):
            main_tensoRF.main(["synthetic", "--device", "cpu", flag])
        return
    ws = str(tmp_path / "ws")
    tr = main_tensoRF.main(["synthetic", "--device", "cpu", "--workspace", ws,
                            *_TINY, flag])
    emap = tr.state.error_map
    assert emap is not None and tuple(emap.shape) == (3, 128 * 128)
    assert (emap != 0.1).any()
    with np.load(os.path.join(ws, "checkpoints",
                              "tensorf_step0000050.npz")) as f:
        np.testing.assert_array_equal(f["error_map"], emap.numpy())
