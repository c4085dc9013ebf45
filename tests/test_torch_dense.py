"""Port parity of the dense oracle: `sample_pdf`, `render_rays_dense` and a
few `Trainer(use_dense=True)` steps against the JAX package, and the
`--dense_render` CLI on the CPU.

The random numbers are explicit inputs: the stratified jitter and the
importance uniforms the reference draws from its key inside
render_rays_dense (one split for each) are rebuilt here and handed to the
port. The field is NGP at 4 levels, T=2^12, on the `xla` backend (fp32
gathers in both packages), with the reference's init tables scaled up so
that the encode drives the field. JAX runs eagerly. Tolerances: samples
1e-5 (absolute plus relative: the two packages' float32 CDF prefix sums
round in another order, and an interval whose probability sits near the
1e-5 floor scales that ulp) with the same intervals picked; image and depth
1e-4; losses rtol 1e-4. Parameter gradients: the MLPs round operands and
cotangents to bf16 on both sides, and a cotangent an ulp apart may round to
the neighbouring bf16 value, so the reference is its own yardstick. Its
jitted and eager gradients at this size differ by up to one bf16 ulp of a
weight leaf's largest entry (6e-3) and, on the two tables that sum such
cotangents over 64 samples a ray, by 1.1-1.4e-2 in relative L2 norm (up to
5e-2 on the largest entry). The port is held to 1e-2 of each MLP leaf's
largest entry (tests/test_torch_train_step.py's bound; measured <= 6e-3)
and to 2e-2 relative L2 on the tables (measured <= 1.1e-2).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_full_rays as j_full_rays
from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays_dense as j_dense
from seal3d_tpu.render.renderer import sample_pdf as j_sample_pdf
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch import main_nerf
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.render.renderer import render_rays_dense as t_dense
from seal3d_tpu_torch.render.renderer import sample_pdf as t_sample_pdf
from seal3d_tpu_torch.train.checkpoint import (flatten_tree, map_tree,
                                              params_from_jax)
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


FIELD = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
             grid_backend="xla", gridtype="hash")
OPTS = dict(bound=1.0, num_steps=32, upsample_steps=32, min_near=0.05)
NUM_RAYS = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense_uniforms(key, n, opts):
    """The jitter and the importance uniforms render_rays_dense draws from
    `key` when it perturbs (one split for each)."""
    key, sub = jax.random.split(key)
    z_jitter = jax.random.uniform(sub, (n, opts["num_steps"]))
    key, sub = jax.random.split(key)
    pdf_u = jax.random.uniform(sub, (n, opts["upsample_steps"]))
    return _t(z_jitter), _t(pdf_u)


@pytest.fixture(scope="module")
def field():
    """(reference params, port params, 64 rays of a synthetic view, their
    ground-truth colours)."""
    cfg = jngp.NGPConfig(**FIELD)
    p = jngp.init(jax.random.PRNGKey(3), cfg)
    p = dict(p, encoder=p["encoder"] * 5e3,
             encoder_color=p["encoder_color"] * 5e3)
    ds = JScene().make_dataset(n_views=1, h=8, w=8, seed=0)
    rays = j_full_rays(jnp.asarray(ds.poses[0]), jnp.asarray(ds.intrinsics),
                       8, 8)
    gt = np.asarray(ds.images[0], np.float32).reshape(-1, 3) / 255.0
    return p, params_from_jax(jax.tree.map(np.asarray, p)), rays, gt


def _bins_weights(seed=0, n=48, k=31):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.1, 3.0, (n, k + 1)), axis=1).astype(np.float32)
    w = rng.exponential(size=(n, k)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.5] = 0.0     # empty intervals
    w[:4] = 0.0                                  # rays that hit nothing
    return bins, w


@pytest.mark.parametrize("given_u", [False, True])
def test_sample_pdf(given_u):
    """Deterministic midpoints and given uniforms: the same interval for
    every sample, positions within 1e-5."""
    bins, w = _bins_weights()
    n = 40
    u = None
    if given_u:
        u = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (48, n)))
    j = np.asarray(j_sample_pdf(jax.random.PRNGKey(1), jnp.asarray(bins),
                                jnp.asarray(w), n, deterministic=not given_u))
    t = t_sample_pdf(_t(bins), _t(w), n,
                     u=None if u is None else _t(u)).numpy()
    interval = lambda s: np.stack([np.searchsorted(b, r, side="right")
                                   for b, r in zip(bins, s)])
    np.testing.assert_array_equal(interval(t), interval(j))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    if not given_u:     # midpoint uniforms: samples in order along the ray
        assert (np.diff(t, axis=1) >= 0).all()


@pytest.mark.parametrize("perturb", [False, True])
def test_render_rays_dense_and_grads(field, perturb):
    jp, tp, rays, gt = field
    jcfg, tcfg = jngp.NGPConfig(**FIELD), tngp.NGPConfig(**FIELD)
    key = jax.random.PRNGKey(9)
    ro, rd = rays["rays_o"], rays["rays_d"]

    def jloss(p):
        out = j_dense(p, jngp, jcfg, ro, rd, JOpts(**OPTS), key=key,
                      bg_color=1.0, perturb=perturb)
        return jnp.mean((out["image"] - gt) ** 2), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    z_jitter, pdf_u = _dense_uniforms(key, ro.shape[0], OPTS)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_tree(tp)}
    tparams = map_tree(tp, lambda k, _: leaves[k])
    tout = t_dense(tparams, tngp, tcfg, _t(ro), _t(rd), TOpts(**OPTS),
                   bg_color=1.0, perturb=perturb, z_jitter=z_jitter,
                   pdf_u=pdf_u)
    tl = ((tout["image"] - _t(gt)) ** 2).mean()
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    np.testing.assert_allclose(tout["image"].detach().numpy(),
                               np.asarray(jout["image"]), atol=1e-4)
    np.testing.assert_allclose(tout["depth"].detach().numpy(),
                               np.asarray(jout["depth"]), atol=1e-4)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert float(tout["weights_sum"].max()) > 0.5   # the field is opaque
    for k, jv in flatten_tree(params_from_jax(jax.tree.map(np.asarray, jg))):
        diff = grads[k] - jv
        if k.startswith("encoder"):
            rel = float(diff.norm() / jv.norm())
            assert rel <= 2e-2, (k, rel)
        else:
            scale = float(jv.abs().max())
            assert float(diff.abs().max()) <= 1e-2 * scale, (k, scale)


def test_dense_trainer_steps_match_jax(field):
    """Four Trainer(use_dense=True) steps on the reference's rays, jitter
    and importance uniforms: no occupancy grid marked, losses within 1e-4."""
    ds = JScene().make_dataset(n_views=2, h=12, w=12, seed=0)
    jp, tp, _, _ = field
    cfg = dict(num_rays=NUM_RAYS, max_steps=100)
    jtr = JTrainer(jngp, jngp.NGPConfig(**FIELD), JOpts(**OPTS), JCfg(**cfg),
                   dataset=ds, key=jax.random.PRNGKey(0), use_dense=True)
    jtr.init_state()
    jtr.state = jtr.state._replace(params=jp)
    ttr = TTrainer(tngp, tngp.NGPConfig(**FIELD), TOpts(**OPTS), TCfg(**cfg),
                   dataset=NeRFDataset(poses=ds.poses, images=ds.images,
                                       intrinsics=ds.intrinsics, h=12, w=12),
                   device="cpu", use_dense=True)
    ttr.init_state()
    assert (ttr.state.occ.density_grid == 0).all()   # no mark_untrained
    ttr.state = ttr.state._replace(params=tp,
                                   opt_state=ttr.optimizer.init(tp))
    key = jax.random.PRNGKey(4)
    jl, tl = [], []
    for _ in range(4):
        key, kstep = jax.random.split(key)
        kimg, kray, _, kjit = jax.random.split(kstep, 4)
        img_idx = jax.random.randint(kimg, (), 0, len(ds))
        rays = j_get_rays(kray, jnp.asarray(ds.poses)[img_idx],
                          jnp.asarray(ds.intrinsics), 12, 12, NUM_RAYS)
        z_jitter, pdf_u = _dense_uniforms(kjit, NUM_RAYS, OPTS)
        rand = StepRandom(img_idx=torch.tensor(int(img_idx)),
                          inds=_t(rays["inds"]).long(), bg=None, jitter=None,
                          z_jitter=z_jitter, pdf_u=pdf_u)
        jtr.state, jm = jtr._train_step(jtr.state, kstep)
        tm = ttr.train_step(rand)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(ttr.state.step) == 4
    # the trainer's own draws have the dense shapes
    r = ttr.draw_step_random()
    assert r.jitter is None and r.z_jitter.shape == (NUM_RAYS, 32)
    assert r.pdf_u.shape == (NUM_RAYS, 32)


def test_dense_render_cli(tmp_path):
    """`--dense_render` at a tiny size on the CPU: trains without grid
    updates, evaluates and renders through the dense oracle, writes its
    checkpoints."""
    ws = str(tmp_path / "ws")
    tr = main_nerf.main([
        "synthetic", "--workspace", ws, "--device", "cpu", "--iters", "60",
        "--num_rays", "128", "--H", "32", "--W", "32", "--bound", "1.0",
        "--dense_render", "--num_steps", "32", "--upsample_steps", "0",
        "--min_near", "0.05", "--log2_hashmap_size", "13",
        "--eval_interval", "1000"])
    assert tr.use_dense and int(tr.state.step) == 60
    assert int(tr.state.occ.iter_density) == 0        # no grid update
    assert tr.history[-1]["loss"] < tr.history[0]["loss"], tr.history
    assert np.isfinite(tr.eval_history[-1]["psnr"])
    ckpts = os.listdir(os.path.join(ws, "checkpoints"))
    assert "ngp_step0000060.npz" in ckpts and "ngp_best.npz" in ckpts
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith(".png")]) >= 8
    # every pixel rendered at num_steps samples, no pad slot queried
    assert all(s["chunks_skipped"] == 0 and s["samples"] == 32 * 32 * 32
               for s in tr.render_stats)
