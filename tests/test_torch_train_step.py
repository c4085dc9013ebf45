"""Port parity of one train step and its parts, at the -O train point scaled
down: 4 levels at T=2^12, 256 rays, budget 48, two 24x24 views of the
synthetic scene and the analytic scene's occupancy.

The random numbers of a step are explicit inputs: the test draws them with
the reference's own key splits (trainer.py:329, occupancy.py:131-135) and
hands the same numbers to the port. JAX runs unjitted (eagerly): inside
`jax.jit` XLA:CPU contracts the jittered start t0 + perturb * dt_min into an
FMA, which moves samples. Tolerances:
- loss: rtol 1e-4 against fp32 encodes (xla/hash; halo/wrap with the
  reference's K1 replaced by its plain take-gather over
  `corner_indices_weights`, as tests/test_ops.py:365-378 holds K1;
  pallas/hash with K3 replaced the same way; bucket/hash, whose forward is
  the take-gather and whose backward runs the interpreted K2 at f32), 2e-2
  through the interpreted Pallas K1;
- gradients, per leaf: 1e-2 of the leaf's largest entry against fp32
  encodes (the MLP rounds operands and activation cotangents to bf16 on both
  sides, at the same tensors, so sums of bf16-rounded terms differ by
  order; measured <= 2e-3); 4e-2 through the interpreted Pallas K1, whose
  forward rounds every weighted table term and whose backward rounds every
  g*w product to bf16 (measured 3.2e-2 on sigma_net/0/w, 2.5e-2 on
  encoder_color);
- Adam and the schedule against optax over 3 updates: 1e-6 relative;
- EMA and mean_count: 1e-6; the partial grid update as the full one in
  tests/test_torch_occupancy.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops.bitfield import GRID_CELLS
from seal3d_tpu.ops.composite import composite_dense as j_composite_dense
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as j_render_rays
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.data.rays import get_rays as t_get_rays
from seal3d_tpu_torch.data.synthetic import SyntheticScene as TScene
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.ops.composite import composite_dense as t_composite_dense
from seal3d_tpu_torch.render import occupancy as tocc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train.checkpoint import flatten_tree, params_from_jax
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates
from seal3d_tpu_torch.train.trainer import StepRandom
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

OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05)
NUM_RAYS = 256


@pytest.fixture(scope="module")
def scene():
    ds = JScene().make_dataset(n_views=2, h=24, w=24, seed=0)
    occ = jocc.occupancy_update(jocc.occupancy_init(cascades=1),
                                JScene().density, jax.random.PRNGKey(2),
                                bound=1.0, density_thresh=0.01, full=True)
    return ds, occ


def _trainers(scene, backend, gridtype, flat_frac):
    """A JAX and a port trainer with the same params (JAX init, tables
    scaled up so the encode drives the field) and the analytic occupancy."""
    ds, occ = scene
    kw = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
              grid_backend=backend, gridtype=gridtype)
    cfg = dict(num_rays=NUM_RAYS, max_steps=100)
    jtr = JTrainer(jngp, jngp.NGPConfig(**kw),
                   JOpts(**OPTS, flat_frac=flat_frac), JCfg(**cfg),
                   dataset=ds, key=jax.random.PRNGKey(0))
    jtr.init_state()
    p = jtr.state.params
    p = dict(p, encoder=p["encoder"] * 5e3,
             encoder_color=p["encoder_color"] * 5e3)
    jtr.state = jtr.state._replace(params=p, occ=occ)
    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    ttr = TTrainer(tngp, tngp.NGPConfig(**kw),
                   TOpts(**OPTS, flat_frac=flat_frac), TCfg(**cfg),
                   dataset=tds, device="cpu")
    ttr.init_state()
    tocc_state = tocc.OccupancyState(
        *[torch.from_numpy(np.array(a)) for a in occ])
    ttr.state = ttr.state._replace(
        params=params_from_jax(jax.tree.map(np.asarray, p)), occ=tocc_state)
    return jtr, ttr


def _k1_take_oracle(monkeypatch):
    """Route the reference's halo backend through the plain fp32 take-gather
    over `corner_indices_weights` instead of its Pallas kernel."""
    from seal3d_tpu.ops.hashgrid import corner_indices_weights
    from seal3d_tpu.ops.pallas import halo_encode as jhalo

    def oracle(table, x, valid, cfg):
        m = x.shape[0]
        idx, w = corner_indices_weights(x, cfg)
        feats = jnp.take(table, idx.reshape(m, -1), axis=0).reshape(
            m, cfg.num_levels, 8, -1)
        out = (feats * w[..., None]).sum(axis=2).reshape(m, -1)
        return out if valid is None else jnp.where(valid[:, None], out, 0.0)

    monkeypatch.setattr(jhalo, "halo_expand", lambda table, cfg: table)
    monkeypatch.setattr(jhalo, "halo_encode_fused", oracle)


def _k3_take_oracle(monkeypatch):
    """Route the reference's pallas backend through the plain fp32
    take-gather instead of its Pallas kernel K3 (whose level stack
    [L, T/128, F*128] is unpacked back to the flat table first)."""
    from seal3d_tpu.ops.hashgrid import corner_indices_weights
    from seal3d_tpu.ops.pallas import hash_encode as jhash

    def oracle(stack, x, cfg, tile=1024):
        levels, rows, fw = stack.shape
        f = fw // 128
        table = stack.reshape(levels, rows, f, 128).transpose(
            0, 1, 3, 2).reshape(-1, f)
        m = x.shape[0]
        idx, w = corner_indices_weights(x, cfg)
        feats = jnp.take(table, idx.reshape(m, -1), axis=0).reshape(
            m, cfg.num_levels, 8, -1)
        return (feats * w[..., None]).sum(axis=2).reshape(m, -1)

    monkeypatch.setattr(jhash, "hash_encode_fused", oracle)


@pytest.mark.parametrize("backend,gridtype,flat_frac,k1,tol", [
    ("xla", "hash", None, None, 1e-2),   # [N, K] grid branch (pre-retune)
    ("xla", "hash", 0.5, None, 1e-2),    # single-level flat branch
    ("halo", "wrap", None, "take", 1e-2),  # the -O field, both branches
    ("halo", "wrap", 0.5, "take", 1e-2),
    ("halo", "wrap", 0.5, "pallas", 4e-2),
    ("bucket", "hash", 0.5, "pallas", 1e-2),  # the interpreted K2 backward
    ("pallas", "hash", None, "take", 1e-2),   # K3 as its fp32 take-oracle
])
def test_step_loss_and_grads_match_jax(scene, monkeypatch, backend, gridtype,
                                       flat_frac, k1, tol):
    ds, _ = scene
    if k1 == "take":
        oracle = _k3_take_oracle if backend == "pallas" else _k1_take_oracle
        oracle(monkeypatch)
    jtr, ttr = _trainers(scene, backend, gridtype, flat_frac)
    kimg, kray, _, kjit = jax.random.split(jax.random.PRNGKey(11), 4)
    img_idx = jax.random.randint(kimg, (), 0, len(ds))
    rays = j_get_rays(kray, jnp.asarray(ds.poses)[img_idx],
                      jnp.asarray(ds.intrinsics), ds.h, ds.w, NUM_RAYS)
    jitter = jax.random.uniform(kjit, (NUM_RAYS,))
    st = jtr.state
    img = jnp.asarray(ds.images)[img_idx].reshape(ds.h * ds.w, -1)
    gt = jnp.take(img.astype(jnp.float32) / 255.0, rays["inds"], axis=0)

    def loss_fn(params):
        # render_rays(perturb=True, key=kjit) draws uniform(kjit, (n,)),
        # the jitter handed to the port
        out = j_render_rays(params, jngp, jtr.fcfg, st.occ.bitfield,
                            rays["rays_o"], rays["rays_d"], jtr.opts,
                            key=kjit, bg_color=jnp.ones((NUM_RAYS, 3)),
                            perturb=True,
                            aabb=jtr._march_aabb(st.occ.occ_aabb))
        return ((out["image"] - gt) ** 2).mean(-1).mean(), out

    (jloss, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        st.params)

    rand = StepRandom(img_idx=torch.tensor(int(img_idx)),
                      inds=torch.from_numpy(np.array(rays["inds"])).long(),
                      bg=None, jitter=torch.from_numpy(np.array(jitter)))
    batch = ttr.sample_batch(rand)
    np.testing.assert_allclose(batch["rays_d"].numpy(),
                               np.asarray(rays["rays_d"]), atol=1e-6)
    np.testing.assert_allclose(batch["gt"].numpy(), np.asarray(gt), atol=0)
    tloss, tgrads, tout = ttr.loss_and_grads(ttr.state.params, ttr.state.occ,
                                             batch, rand.jitter)
    assert int(tout["num_samples"]) == int(jout["num_samples"]) > 0
    np.testing.assert_allclose(
        float(tloss), float(jloss),
        rtol=2e-2 if (backend, k1) == ("halo", "pallas") else 1e-4)
    jflat = {k: np.asarray(v) for k, v in
             zip([k for k, _ in flatten_tree(tgrads)],
                 jax.tree.leaves(jgrads))}
    for k, v in flatten_tree(tgrads):
        ref = jflat[k]
        scale = float(np.abs(ref).max())
        assert scale > 0, k
        np.testing.assert_allclose(v.numpy() / scale, ref / scale, atol=tol,
                                   err_msg=k)


def test_adam_and_schedule_match_optax():
    """The reference's chain (trainer.py:246-253) over 3 updates at 1e-6,
    and its optax state layout (the checkpoint keys)."""
    from seal3d_tpu.train.checkpoint import _path_str

    rng = np.random.default_rng(0)
    params = {"encoder": rng.normal(size=(96, 4)).astype(np.float32),
              "sigma_net": [{"w": rng.normal(size=(8, 16)).astype(np.float32)}]}
    lr, max_steps = 1e-2, 2
    jopt = JTrainer(jngp, jngp.NGPConfig(), JOpts(),
                    JCfg(lr=lr, max_steps=max_steps)).optimizer
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = Optimizer(lr, max_steps)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = topt.init(tp)
    for _ in range(3):   # the third passes max_steps: the LR stays at 0.1 lr
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         params)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts)
        tp = apply_updates(tp, tu)
        for (k, u), ref in zip(flatten_tree(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(u.numpy(), np.asarray(ref), rtol=1e-6,
                                       err_msg=k)
    jl = {_path_str(p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(js)[0]}
    tl = {k: v.numpy() for k, v in flatten_tree(ts)}
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-6, err_msg=k)
    assert tl["0/count"].dtype == np.int32 and int(tl["1/count"]) == 3


def test_train_step_updates_ema_and_mean_count(scene):
    """Two port train steps: Adam from the step's own gradient, EMA 0.95 of
    the new params, the mean_count EMA (first step: the sample count), and
    the step counter."""
    ds, _ = scene
    _, ttr = _trainers(scene, "xla", "hash", 0.5)
    rng = np.random.default_rng(4)
    mc = -1.0
    for _ in range(2):
        st = ttr.state
        rand = StepRandom(img_idx=torch.tensor(1),
                          inds=torch.from_numpy(rng.integers(0, 24 * 24,
                                                             NUM_RAYS)),
                          bg=None,
                          jitter=torch.from_numpy(
                              rng.uniform(size=NUM_RAYS).astype(np.float32)))
        _, grads, out = ttr.loss_and_grads(st.params, st.occ,
                                           ttr.sample_batch(rand), rand.jitter)
        updates, _ = ttr.optimizer.update(grads, st.opt_state)
        m = ttr.train_step(rand)
        new = ttr.state
        ns = float(out["num_samples"])
        assert float(m["num_samples"]) == ns > 0
        mc = ns if mc < 0 else mc * 0.9 + ns * 0.1
        np.testing.assert_allclose(float(new.occ.mean_count), mc, rtol=1e-6)
        want = dict(flatten_tree(apply_updates(st.params, updates)))
        ema0 = dict(flatten_tree(st.ema_params))
        ema1 = dict(flatten_tree(new.ema_params))
        for k, p in flatten_tree(new.params):
            np.testing.assert_allclose(p.numpy(), want[k].numpy(), atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(
                ema1[k].numpy(), ema0[k].numpy() * 0.95 + p.numpy() * 0.05,
                atol=1e-6, err_msg=k)
    assert int(ttr.state.step) == 2
    assert int(ttr.state.opt_state[0].count) == 2


def test_partial_occupancy_update_matches_jax():
    """The partial update (rotating strided slice at phase iter_density % 8
    plus inverse-CDF occupied resamples) with the reference's random numbers
    rebuilt from its key; the density is each package's analytic scene."""
    rng = np.random.default_rng(0)
    prior = rng.uniform(0.0, 0.02, size=(1, GRID_CELLS)).astype(np.float32)
    prior[rng.uniform(size=prior.shape) < 0.1] = -1.0
    prior[0, rng.integers(0, GRID_CELLS, 5000)] = 30.0   # occupied cells
    key = jax.random.PRNGKey(5)
    jst = jocc.occupancy_init(1)._replace(density_grid=jnp.asarray(prior),
                                          iter_density=jnp.int32(19))
    jout = jocc.occupancy_update(jst, JScene().density, key, bound=1.0,
                                 density_thresh=10.0, full=False)
    _, k2, k3 = jax.random.split(key, 3)
    n_uni, n_occ = GRID_CELLS // 8, 2**16
    uniforms = np.array(jax.random.uniform(k2, (n_occ,)))[None]
    jitter = np.array(jax.random.uniform(k3, (n_uni + n_occ, 3)))[None]

    tst = tocc.occupancy_init(1)._replace(
        density_grid=torch.from_numpy(prior),
        iter_density=torch.tensor(19, dtype=torch.int32))
    tout = tocc.occupancy_update(tst, TScene().density, bound=1.0,
                                 density_thresh=10.0, full=False,
                                 jitter=torch.from_numpy(jitter),
                                 uniforms=torch.from_numpy(uniforms))
    np.testing.assert_allclose(tout.density_grid.numpy(),
                               np.asarray(jout.density_grid), rtol=1e-4,
                               atol=1e-6)
    n_diff = int(np.unpackbits(np.asarray(jout.bitfield)
                               ^ tout.bitfield.numpy()).sum())
    assert n_diff <= 1e-4 * GRID_CELLS, n_diff
    np.testing.assert_allclose(float(tout.mean_density),
                               float(jout.mean_density), rtol=1e-5)
    assert int(tout.iter_density) == 20
    # the slice (phase 19 % 8 = 3) and at most 2^16 resampled cells changed
    changed = tout.density_grid.numpy()[0] != prior[0]
    assert changed[3::8].mean() > 0.8
    assert 0 < changed.sum() - changed[3::8].sum() <= n_occ


def test_get_rays_with_injected_pixels():
    ds = JScene().make_dataset(n_views=1, h=20, w=28, seed=3)
    key = jax.random.PRNGKey(8)
    j = j_get_rays(key, jnp.asarray(ds.poses[0]), jnp.asarray(ds.intrinsics),
                   20, 28, 500)
    t = t_get_rays(torch.from_numpy(ds.poses[0]),
                   torch.from_numpy(ds.intrinsics), 20, 28, 500,
                   inds=torch.from_numpy(np.array(j["inds"])).long())
    np.testing.assert_array_equal(t["inds"].numpy(), np.asarray(j["inds"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-6)
    drawn = t_get_rays(torch.from_numpy(ds.poses[0]),
                       torch.from_numpy(ds.intrinsics), 20, 28, 500,
                       generator=torch.Generator().manual_seed(0))
    assert drawn["inds"].min() >= 0 and drawn["inds"].max() < 20 * 28


def test_composite_dense_valid_mask():
    """Fault 1: invalid slots of the [N, K] grid contribute no optical
    depth (the reference masks sdelta); without the mask they would."""
    rng = np.random.default_rng(2)
    sig = rng.uniform(0, 20, (64, 48)).astype(np.float32)
    rgb = rng.uniform(0, 1, (64, 48, 3)).astype(np.float32)
    dt = rng.uniform(0.001, 0.02, (64, 48)).astype(np.float32)
    ts = np.cumsum(dt, 1).astype(np.float32)
    valid = rng.uniform(size=(64, 48)) < 0.6
    j = j_composite_dense(*map(jnp.asarray, (sig, rgb, dt, ts, valid)))
    t = t_composite_dense(*map(torch.from_numpy, (sig, rgb, dt, ts, valid)))
    for k in ("weights", "weights_sum", "depth", "image"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-6,
                                   err_msg=k)
    assert (t["weights"].numpy()[~valid] == 0).all()
    unmasked = t_composite_dense(*map(torch.from_numpy, (sig, rgb, dt, ts)))
    assert float((unmasked["image"] - t["image"]).abs().max()) > 1e-2


def test_metrics_match_jax():
    """psnr, ssim and lpips_proxy of the port against the reference's
    (numpy vs jnp float32: 1e-5), and the meters' means."""
    from seal3d_tpu.train import metrics as jm
    from seal3d_tpu_torch.train import metrics as tm

    rng = np.random.default_rng(0)
    a = rng.uniform(size=(40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim", "lpips_proxy"):
        np.testing.assert_allclose(getattr(tm, name)(a, b),
                                   getattr(jm, name)(a, b), rtol=1e-5,
                                   err_msg=name)
    meter, pmeter = tm.PSNRMeter(), tm.PerceptualMeter()
    for img in (a, np.clip(a + 0.1, 0, 1)):
        meter.update(img, b)
        pmeter.update(img, b)
    jmeter = jm.PSNRMeter()
    jmeter.update(a, b)
    jmeter.update(np.clip(a + 0.1, 0, 1), b)
    np.testing.assert_allclose(meter.measure(), jmeter.measure(), rtol=1e-6)
    assert pmeter.kind == "lpips_proxy" and pmeter.measure() > 0
    assert tm.psnr(a, a) == 99.0
