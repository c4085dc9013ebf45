"""Port parity of the D-NeRF family against the JAX package: the field's
three variants, the positions' gradient of every grid backend, the
time-sliced occupancy update, the `lr_net_scale` stage, the dynamic
synthetic scene, 96 train steps side by side on `halo` and on `xla`, and the
`main_dnerf` CLI on the CPU.

Both packages get the same params (the JAX init, carried by path) and every
random number (rays, march jitter, sigma_reg points, the grid update's
cells, jitter and time jitter), drawn once from the reference's own key
splits. Where the JAX side would run a Pallas kernel over many steps (K1 on
`halo`), it runs its fp32 take-gather over `corner_indices_weights` with the
positions' gradient stopped, which is the kernel's custom vjp; the
positions-gradient test runs the interpreted kernels themselves once each,
at a small size.

Tolerances:
- field outputs: rtol 1e-4, atol 1e-5 (both packages round the MLP operands
  to bf16 and accumulate in fp32, so only summation order differs; a warped
  position carries the deform net's rounding into the grid);
- positions' gradient: 1e-5 of its largest entry against jax.grad (`xla`,
  `bucket`); exactly zero in both on `halo` and fused `pallas`;
- the time-grid update on an analytic density: densities within 1e-6,
  bitfields equal;
- the lr_net_scale chain: 1e-6 relative against optax over 3 updates;
- training: the mean loss of each 16-step block within 10%, val PSNR within
  0.3 dB.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import DynamicSyntheticScene as JScene
from seal3d_tpu.models import dnerf as jdn
from seal3d_tpu.ops import hashgrid as jhg
from seal3d_tpu.ops.bitfield import GRID_CELLS
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.train.dnerf_trainer import DNeRFTrainer as JTrainer
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import _scale_non_encoder
from seal3d_tpu_torch import main_dnerf
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.data.synthetic import DynamicSyntheticScene as TScene
from seal3d_tpu_torch.models import dnerf as tdn
from seal3d_tpu_torch.ops import hashgrid as thg
from seal3d_tpu_torch.render import occupancy as tocc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.dnerf_trainer import DNeRFTrainer as TTrainer
from seal3d_tpu_torch.train.dnerf_trainer import l1
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates
from seal3d_tpu_torch.train.trainer import StepRandom
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from test_torch_train_step import NUM_RAYS, OPTS


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# a small deform / time net; the grid keeps the family's 16 levels, F=2
SMALL = dict(bound=1.0, log2_hashmap_size=12, num_layers_time=3,
             hidden_dim_time=32, time_multires=2)
FIELD_RTOL, FIELD_ATOL = 1e-4, 1e-5
STEPS, BLOCK, TIME_SIZE, CELLS = 96, 16, 4, 2**16
GRID_EVERY = 16
PSNR_TOL_DB = 0.3
BLOCK_LOSS_RTOL = 0.10


def _cfgs(**kw):
    kw = dict(SMALL, **kw)
    return jdn.DNeRFConfig(**kw), tdn.DNeRFConfig(**kw)


def _carry(jp):
    return tckpt.params_from_jax(jax.tree.map(np.asarray, jp))


def _points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, size=n).astype(np.float32)
    return x, d, t


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=FIELD_RTOL, atol=FIELD_ATOL, err_msg=msg)


# ------------------------------------------------------------------- field

@pytest.mark.parametrize("variant", ["deform", "basis", "hyper"])
def test_variants_match_jax(variant):
    """apply / density / deformation of each variant on the plain gather
    (`tiled` grid, the CLI's default without -O), at one time and at a time
    per point; the deform head made non-zero, so the warp acts."""
    jcfg, tcfg = _cfgs(variant=variant)
    assert tcfg.grid.level_params == jcfg.grid.level_params
    jp = jdn.init(jax.random.PRNGKey(1), jcfg)
    if variant == "deform":
        # zero at init in both packages, then a random head
        own = tdn.init(tcfg, generator=torch.Generator().manual_seed(0))
        assert not own["deform_net"][-1]["w"].any()
        assert not np.asarray(jp["deform_net"][-1]["w"]).any()
        jp["deform_net"][-1]["w"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(2), jp["deform_net"][-1]["w"].shape)
    tp = _carry(jp)
    x, d, tv = _points()
    for t in (np.float32(0.3), tv):
        js, jc, jw = jdn.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(d),
                               jnp.asarray(t))
        ts, tc, tw = tdn.apply(tp, tcfg, torch.from_numpy(x),
                               torch.from_numpy(d), torch.from_numpy(
                                   np.asarray(t)))
        _close(ts, js, "sigma")
        _close(tc, jc, "rgb")
        assert (tw is None) == (jw is None)
        jd = jdn.density(jp, jcfg, jnp.asarray(x), jnp.asarray(t))
        td = tdn.density(tp, tcfg, torch.from_numpy(x),
                         torch.from_numpy(np.asarray(t)))
        assert set(jd) == set(td)
        for k in jd:
            _close(td[k].detach(), jd[k], k)
        if variant == "deform":
            _close(tw.detach(), jw, "warped")
            _close(tdn.deformation(tp, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(np.asarray(t))).detach(),
                   jdn.deformation(jp, jcfg, jnp.asarray(x), jnp.asarray(t)))
            assert float(np.abs(np.asarray(jw) - x).max()) > 1e-3
    # the renderer's time-less adapter
    jt, tt = jdn.with_time(jnp.float32(0.6)), tdn.with_time(torch.tensor(0.6))
    js, jc = jt.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(d))
    ts, tc = tt.apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d),
                      valid=torch.ones(len(x), dtype=torch.bool))
    _close(ts.detach(), js)
    _close(tc.detach(), jc)
    if variant == "basis":
        with pytest.raises(NotImplementedError):
            tt.color(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d), None)
    else:
        td = tt.density(tp, tcfg, torch.from_numpy(x))
        jd = jt.density(jp, jcfg, jnp.asarray(x))
        _close(tt.color(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d),
                        td["geo_feat"]).detach(),
               jt.color(jp, jcfg, jnp.asarray(x), jnp.asarray(d),
                        jd["geo_feat"]))


def test_params_tree_keys_and_init_shapes():
    for variant, net in (("deform", "deform_net"), ("basis", "basis_net"),
                         ("hyper", "ambient_net")):
        jcfg, tcfg = _cfgs(variant=variant)
        jp = jdn.init(jax.random.PRNGKey(0), jcfg)
        jl = {k: v.shape for k, v in
              tckpt.flatten_tree(_carry(jp))}
        own = {k: tuple(v.shape) for k, v in tckpt.flatten_tree(
            tdn.init(tcfg, generator=torch.Generator().manual_seed(0)))}
        assert own == {k: tuple(v) for k, v in jl.items()}
        assert any(k.startswith(net) for k in own)
    # hyper's 4-D grid is on the plain gather whatever the backend
    _, tcfg = _cfgs(variant="hyper", grid_backend="halo", gridtype="wrap")
    assert tcfg.grid.input_dim == 4 and tcfg.grid.backend == "xla"


# ------------------------------------------------------ positions' gradient

GRAD_GRID = dict(num_levels=4, level_dim=2, base_resolution=4,
                 desired_resolution=64, log2_hashmap_size=12)
BACKEND_GRIDTYPE = {"xla": "tiled", "bucket": "hash", "pallas": "hash",
                    "halo": "wrap"}


@pytest.mark.parametrize("backend", ["xla", "bucket", "pallas", "halo"])
def test_positions_gradient_matches_jax_grad(backend):
    """d/dx sum(encode(x) * G) against jax.grad on each backend, the
    reference running its own (interpreted) kernels: `xla` by autodiff,
    `bucket` by its `_bucket_encode_bwd` formula, fused `pallas` and `halo`
    none (zeros from jax.grad, no gradient in the port)."""
    kw = dict(GRAD_GRID, backend=backend, gridtype=BACKEND_GRIDTYPE[backend])
    jc, tc = jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)
    rng = np.random.default_rng(3)
    tab = rng.uniform(-0.5, 0.5, size=(tc.total_params, 2)).astype(np.float32)
    x = rng.uniform(0.02, 0.98, size=(64, 3)).astype(np.float32)
    g = rng.normal(size=(64, 4 * 2)).astype(np.float32)

    def jloss(xx):
        return (jhg.hashgrid_encode(jnp.asarray(tab), xx, jc) * g).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (thg.hashgrid_encode(torch.from_numpy(tab), xt, tc)
     * torch.from_numpy(g)).sum().backward()
    if backend in ("halo", "pallas"):
        assert not want.any(), backend
        assert xt.grad is None
        return
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0,
                               atol=1e-5 * scale)


def _k1_take_oracle_no_dx(monkeypatch):
    """The reference's halo backend through its fp32 take-gather, the
    positions' gradient stopped as K1's custom vjp stops it."""
    from seal3d_tpu.ops.pallas import halo_encode as jhalo

    def oracle(table, x, valid, cfg):
        x = jax.lax.stop_gradient(x)
        m = x.shape[0]
        idx, w = jhg.corner_indices_weights(x, cfg)
        feats = jnp.take(table, idx.reshape(m, -1), axis=0).reshape(
            m, cfg.num_levels, 8, -1)
        out = (feats * w[..., None]).sum(axis=2).reshape(m, -1)
        return out if valid is None else jnp.where(valid[:, None], out, 0.0)

    monkeypatch.setattr(jhalo, "halo_expand", lambda table, cfg: table)
    monkeypatch.setattr(jhalo, "halo_encode_fused", oracle)


def test_halo_deform_net_gets_no_field_gradient(monkeypatch):
    """A shared trait: under -O (halo) the deform net gets no gradient
    from the field in either package, and with deform_reg the L1 term
    alone moves it, by +1 x its input at dx = 0 (jnp.abs's gradient at 0,
    which torch.abs would not give)."""
    _k1_take_oracle_no_dx(monkeypatch)
    jcfg, tcfg = _cfgs(grid_backend="halo", gridtype="wrap")
    jp = jdn.init(jax.random.PRNGKey(4), jcfg)
    tp = _carry(jp)
    x, d, _ = _points(128, seed=5)
    w = np.random.default_rng(6).normal(size=(128,)).astype(np.float32)

    def jloss(p, reg):
        s, c, _ = jdn.apply(p, jcfg, jnp.asarray(x), jnp.asarray(d),
                            jnp.float32(0.4))
        dx = jdn.deformation(p, jcfg, jnp.asarray(x), jnp.float32(0.4))
        return (s * w).sum() + c.sum() + reg * jnp.abs(dx).mean()

    def tloss(p, reg):
        s, c, _ = tdn.apply(p, tcfg, torch.from_numpy(x), torch.from_numpy(d),
                            torch.tensor(0.4))
        dx = tdn.deformation(p, tcfg, torch.from_numpy(x), torch.tensor(0.4))
        return (s * torch.from_numpy(w)).sum() + c.sum() + reg * l1(dx).mean()

    for reg in (0.0, 1e-3):
        jg = jax.grad(jloss)(jp, reg)["deform_net"]
        leaves = [t["w"].clone().requires_grad_() for t in tp["deform_net"]]
        p = dict(tp, deform_net=[{"w": t} for t in leaves])
        tg = torch.autograd.grad(tloss(p, reg), leaves, allow_unused=True)
        for i, (jw, tw) in enumerate(zip(jg, tg)):
            jw = np.asarray(jw["w"])
            tw = np.zeros_like(jw) if tw is None else tw.numpy()
            if reg == 0.0:
                assert not jw.any() and not tw.any(), i
            else:
                np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-9)
        if reg:
            assert np.abs(np.asarray(jg[-1]["w"])).max() > 0
    # the trap itself: torch.abs's gradient at 0 is 0, the L1's is 1
    z = torch.zeros(3, requires_grad=True)
    assert not torch.autograd.grad(z.abs().sum(), z)[0].any()
    assert torch.equal(torch.autograd.grad(l1(z).sum(), z)[0], torch.ones(3))
    np.testing.assert_array_equal(
        np.asarray(jax.grad(lambda v: jnp.abs(v).sum())(jnp.zeros(3))),
        np.ones(3))


# ---------------------------------------------------------- time occupancy

def _t_update_draws(key, t_indices, cascades, q):
    """The numbers jocc.occupancy_t_update draws from `key`, per refreshed
    slice and cascade: (uni codes, occupied uniforms, jitter, time jitter)."""
    uni, u, jit, tj = [], [], [], []
    for _ in t_indices:
        row = ([], [], [], [])
        for _ in range(cascades):
            key, k1, k2, k3, k4 = jax.random.split(key, 5)
            row[0].append(np.array(jax.random.randint(k1, (q,), 0, GRID_CELLS)))
            row[1].append(np.array(jax.random.uniform(k2, (q,))))
            row[2].append(np.array(jax.random.uniform(k3, (2 * q, 3))))
            row[3].append(np.array(jax.random.uniform(k4, (2 * q,))))
        for acc, r in zip((uni, u, jit, tj), row):
            acc.append(np.stack(r))
    return {k: torch.from_numpy(np.stack(v)) for k, v in zip(
        ("uni_codes", "uniforms", "jitter", "time_jitter"), (uni, u, jit, tj))}


def test_occupancy_t_update_matches_jax():
    """Two refreshes of a moving ball's density on given cells: the first
    over slices 0-3 of an empty grid, the second over slices 2, 3, 0 (the
    cursor wrapping) with the occupied-cell resamples active."""
    q = 2**13

    def jdens(x, t):
        c = jnp.stack([t - 0.5, jnp.zeros_like(t), jnp.zeros_like(t)], -1)
        return 50.0 * (jnp.linalg.norm(x - c, axis=-1) < 0.3)

    def tdens(x, t):
        c = torch.stack([t - 0.5, torch.zeros_like(t), torch.zeros_like(t)],
                        -1)
        return 50.0 * (torch.linalg.norm(x - c, dim=-1) < 0.3).float()

    js = jocc.occupancy_t_init(time_size=4, cascades=1)
    ts = tocc.occupancy_t_init(time_size=4, cascades=1)
    for seed, slices in ((0, [0, 1, 2, 3]), (1, [2, 3, 0])):
        key = jax.random.PRNGKey(seed)
        js = jocc.occupancy_t_update(js, jdens, key, bound=1.0,
                                     t_indices=jnp.asarray(slices),
                                     cells_per_slice=q, query_chunk=2**14)
        ts = tocc.occupancy_t_update(ts, tdens, 1.0, slices,
                                     cells_per_slice=q, query_chunk=2**14,
                                     **_t_update_draws(key, slices, 1, q))
        np.testing.assert_allclose(ts.density_grid.numpy(),
                                   np.asarray(js.density_grid), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(ts.bitfield.numpy(),
                                      np.asarray(js.bitfield))
        np.testing.assert_allclose(float(ts.mean_density),
                                   float(js.mean_density), rtol=1e-5)
        assert int(ts.iter_density) == int(js.iter_density)
    occ = ts.density_grid.numpy() > 0.01
    assert occ.any(axis=(1, 2)).all() and (occ[0] != occ[3]).any()


# ------------------------------------------------------------- optimizer

def test_lr_net_scale_stage_matches_optax():
    """The chain with `_scale_non_encoder(0.1)`: MLP updates a tenth,
    encoder updates whole, and the empty third state adds no key."""
    lr, max_steps = 1e-2, 10
    jopt = optax.chain(optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
                       optax.scale_by_schedule(
                           lambda s: -lr * 0.1 ** jnp.minimum(s / max_steps,
                                                              1.0)),
                       _scale_non_encoder(0.1))
    topt = Optimizer(lr, max_steps, net_scale=0.1)
    jcfg, _ = _cfgs()
    jp = jdn.init(jax.random.PRNGKey(3), jcfg)
    tp = _carry(jp)
    js, ts = jopt.init(jp), topt.init(tp)
    jkeys = {jkey for jkey in _jpaths(js)}
    assert jkeys == {k for k, _ in tckpt.flatten_tree(ts)}
    assert len(ts) == 3 and "0/mu/encoder" in jkeys
    rng = np.random.default_rng(4)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, jp))
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(tckpt.params_from_jax(g), ts)
        tp = apply_updates(tp, tu)
        got = dict(tckpt.flatten_tree(tu))
        for k, v in _jpaths(ju).items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6,
                                       atol=1e-9, err_msg=f"{step} {k}")
    # the MLP updates are a tenth of the unscaled chain's, the encoder's not
    plain = Optimizer(lr, max_steps)
    u1, _ = plain.update(tckpt.params_from_jax(g), plain.init(tp))
    u2, _ = topt.update(tckpt.params_from_jax(g), topt.init(tp))
    assert torch.allclose(u2["encoder"], u1["encoder"])
    assert torch.allclose(u2["sigma_net"][0]["w"], 0.1 * u1["sigma_net"][0]["w"])


def _jpaths(tree):
    from seal3d_tpu.train import checkpoint as jckpt

    return {jckpt._path_str(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ----------------------------------------------------------------- scene

def test_dynamic_scene_views_match_jax():
    jds = JScene().make_dataset(n_views=8, h=20, w=20, seed=0,
                                views_per_time=4)
    tds = TScene().make_dataset(n_views=8, h=20, w=20, seed=0,
                                views_per_time=4)
    np.testing.assert_array_equal(tds.times, jds.times)
    np.testing.assert_array_equal(tds.poses, jds.poses)
    assert len(np.unique(tds.times)) == 2
    diff = np.abs(tds.images.astype(int) - jds.images.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    # the moving ball: two times of one pose render differently
    x = torch.tensor([[0.4, 0.1, 0.0]])
    assert float(TScene().density_t(x, 0.0)) > 30.0
    assert float(TScene().density_t(x, 0.25)) < 1.0
    # the default two views a time, and a remainder at time 1
    t5 = TScene().make_dataset(n_views=5, h=8, w=8, seed=0).times
    np.testing.assert_array_equal(
        t5, JScene().make_dataset(n_views=5, h=8, w=8, seed=0).times)


# ------------------------------------------------------------ train run

@pytest.fixture(scope="module")
def scene():
    train = JScene().make_dataset(n_views=8, h=24, w=24, seed=0)
    val = JScene().make_dataset(n_views=2, h=24, w=24, seed=1)
    return train, val


def _to_port(ds):
    return NeRFDataset(poses=ds.poses, images=ds.images,
                       intrinsics=ds.intrinsics, h=ds.h, w=ds.w,
                       times=ds.times)


RUNS = {}


def _run(scene, backend):
    if backend not in RUNS:
        with pytest.MonkeyPatch.context() as mp:
            RUNS[backend] = _train_both(scene, backend, mp)
    return RUNS[backend]


def _train_both(scene, backend, monkeypatch):
    """96 steps of both trainers from the same params on the same numbers
    -> (reference losses, port losses, reference PSNR, port PSNR, the port
    trainer)."""
    train, val = scene
    if backend == "halo":
        _k1_take_oracle_no_dx(monkeypatch)
        kw = dict(grid_backend="halo", gridtype="wrap")
        regs = dict(deform_reg=1e-3)
    else:
        kw = dict(grid_backend="xla", gridtype="tiled")
        regs = dict(deform_reg=1e-3, sigma_reg=1e-3)
    jcfg, tcfg = _cfgs(**kw)
    # the MLPs at the grid's rate: at the CLI's tenth, 96 steps of a tiny
    # field stay near the untrained PSNR (the scale is held to optax in
    # test_lr_net_scale_stage_matches_optax and runs in the CLI test)
    cfg = dict(num_rays=NUM_RAYS, max_steps=STEPS, eval_chunk=1024,
               eval_budget_per_ray=48)
    jtr = JTrainer(jcfg, JOpts(**OPTS), JCfg(**cfg), dataset=train,
                   key=jax.random.PRNGKey(0), time_size=TIME_SIZE, **regs)
    jtr.init_state()
    ttr = TTrainer(tcfg, TOpts(**OPTS), TCfg(**cfg), dataset=_to_port(train),
                   device="cpu", time_size=TIME_SIZE, **regs)
    ttr.init_state()
    params = _carry(jtr.state.params)
    ttr.state = ttr.state._replace(
        params=params, ema_params=jax.tree.map(torch.clone, params),
        opt_state=ttr.optimizer.init(params))

    def jdens(x, t):
        return jdn.density(jtr.state.params, jcfg, x, t)["sigma"]

    def tdens(x, t):
        return tdn.density(ttr.state.params, tcfg, x, t)["sigma"]

    key = jax.random.PRNGKey(7)
    slices = list(range(TIME_SIZE))
    jlosses, tlosses = [], []
    for i in range(STEPS):
        key, kgrid, kstep = jax.random.split(key, 3)
        if i % GRID_EVERY == 0:
            jtr.state = jtr.state._replace(occ=jocc.occupancy_t_update(
                jtr.state.occ, jdens, kgrid, 1.0, jnp.asarray(slices),
                density_thresh=jtr.cfg.density_thresh, cells_per_slice=CELLS,
                query_chunk=2 * CELLS))
            with torch.no_grad():
                occ = tocc.occupancy_t_update(
                    ttr.state.occ, tdens, 1.0, slices,
                    density_thresh=ttr.cfg.density_thresh,
                    cells_per_slice=CELLS, query_chunk=2 * CELLS,
                    **_t_update_draws(kgrid, slices, 1, CELLS))
            ttr.state = ttr.state._replace(occ=occ)
        kimg, kray, _, kjit = jax.random.split(kstep, 4)
        img_idx = jax.random.randint(kimg, (), 0, len(train))
        rays = j_get_rays(kray, jnp.asarray(train.poses)[img_idx],
                          jnp.asarray(train.intrinsics), train.h, train.w,
                          NUM_RAYS)
        reg = None
        if "sigma_reg" in regs:
            reg = torch.from_numpy(np.array(jax.random.uniform(
                kjit, (4096, 3), minval=-1.0, maxval=1.0)))
        rand = StepRandom(
            img_idx=torch.tensor(int(img_idx)),
            inds=torch.from_numpy(np.array(rays["inds"])).long(), bg=None,
            jitter=torch.from_numpy(np.array(
                jax.random.uniform(kjit, (NUM_RAYS,)))), reg_points=reg)
        jtr.state, jm = jtr._train_step(jtr.state, kstep)
        tm = ttr.train_step(rand)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
    jpsnr = jtr.evaluate(val)
    tpsnr = ttr.evaluate(_to_port(val))
    return np.array(jlosses), np.array(tlosses), jpsnr, tpsnr, ttr


@pytest.mark.parametrize("backend", ["halo", "xla"])
def test_training_side_by_side(scene, backend):
    jl, tl, jpsnr, tpsnr, ttr = _run(scene, backend)
    jb = jl.reshape(-1, BLOCK).mean(1)
    tb = tl.reshape(-1, BLOCK).mean(1)
    print(f"\n[dnerf parity {backend}] val PSNR reference {jpsnr:.3f} dB, "
          f"port {tpsnr:.3f} dB; block losses reference {np.round(jb, 5)}, "
          f"port {np.round(tb, 5)}")
    assert jb[-1] < 0.5 * jb[0] and tb[-1] < 0.5 * tb[0], (jb, tb)
    np.testing.assert_allclose(tb, jb, rtol=BLOCK_LOSS_RTOL)
    assert abs(tpsnr - jpsnr) <= PSNR_TOL_DB, (jpsnr, tpsnr)
    # the deform net moved off its zero head (through the L1 term alone on
    # halo) and the time grid has occupied cells in every slice
    assert ttr.state.params["deform_net"][-1]["w"].abs().max() > 0
    assert (ttr.state.occ.bitfield.reshape(TIME_SIZE, -1) > 0).any(1).all()


# -------------------------------------------------------------------- CLI

def test_main_dnerf_cli_on_cpu(tmp_path):
    """The -O CLI (K1's plain version) at a tiny size through the dense
    oracle at 4 samples a ray, which skips the time-grid update: on the CPU
    one update of the CLI's 8 slices (2^22 points through the full-width
    deform net) takes minutes, and so does a render at 16 samples of the
    -O eval chunk (2^15 rays, a 24x24 view padded to it, as the reference
    pads). The side-by-side runs hold the update. Checks: a step checkpoint with
    the time grid's keys and the optimizer's three-stage state, finite val
    PSNR, 8 test renders, the deform net moved by its L1 term; --gui is
    refused."""
    ws = str(tmp_path / "ws")
    tr = main_dnerf.main([
        "synthetic_dynamic", "-O", "--dense_render", "--bound", "1.0",
        "--min_near", "0.05", "--num_steps", "4", "--upsample_steps", "0",
        "--H", "24", "--W", "24", "--num_rays", "256", "--num_views", "8",
        "--views_per_time", "4", "--time_multires", "2", "--deform_reg",
        "1e-3", "--time_size", "4", "--log2_hashmap_size", "12", "--iters",
        "24", "--device", "cpu", "--workspace", ws])
    assert tr.fcfg.grid.backend == "halo" and tr.fcfg.gridtype == "wrap"
    assert tr.cfg.lr_net_scale == 0.1 and len(tr.state.opt_state) == 3
    with np.load(os.path.join(ws, "checkpoints",
                              "dnerf_step0000024.npz")) as f:
        assert f["occ/density_grid"].shape == (4, 1, GRID_CELLS)
        assert f["occ/bitfield"].shape == (4, GRID_CELLS // 8)
        assert "opt_state/1/count" in f.files
        assert not any(k.startswith("opt_state/2") for k in f.files)
    assert np.isfinite(tr.eval_history[-1]["psnr"])
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 8
    assert tr.state.params["deform_net"][-1]["w"].abs().max() > 0
    with pytest.raises(NotImplementedError, match="GUI state"):
        main_dnerf.main(["synthetic_dynamic", "--device", "cpu", "--gui"])
