"""The port's multi-rank layer on the CPU: gloo ranks spawned by
seal3d_tpu_torch/parallel/launch.py, held against the JAX package.

- `compact_flat_sharded` against the JAX function on the same candidates,
  2 and 4 shards, under and over budget: integers exact, floats to 1e-6;
- one port step with pack_shards=2 and no mesh against the JAX Trainer's
  (pack_shards=2), run eagerly (inside jit XLA:CPU contracts the jittered
  march start into an FMA): loss 1e-4 relative, gradients 1e-2 of each
  leaf's largest entry (the MLPs round to bf16 on both sides);
- dp2 over two gloo ranks (`Trainer(mesh=make_mesh(2))`), three steps on
  the same rays and jitter, against the JAX Trainer with the settings a
  2-device data mesh derives (pack_shards=2, march_two_level=False), whose
  loss is a mean over the global batch: the loss of every step 1e-4
  relative; the params after the steps against the JAX Trainer's (each
  entry within the 2 lr a step of a flipped sign, at most 0.1% of each
  leaf's entries off by more than 0.1 lr) and against the single-process
  port (pack_shards=2): 1e-5 of each leaf's largest entry; the step log
  sums each gradient once (the MLP weights' at their casts, the rest in
  one collective) and holds no batch-scale collective;
- a Trainer without a mesh after one on a dp2 x tp2 mesh, in one rank:
  the ambient mesh is its own (None), so its step issues no collective on
  the other's mesh and rounds its MLP weight gradients itself;
- dp2 x tp2 with the error map and a checkpoint (rank 0 writes whole
  tables that load without a mesh); D-NeRF over two ranks against one
  process;
- the level-sharded encode under make_mesh_2d(2, 2) on `xla` (the case of
  tests/test_parallel.py: 8 levels, F=2, T=2^10) against the JAX encode:
  features and table gradient 1e-6, no table-sized collective on 'model';
  on `halo` (1 x 2 ranks, plain K1 over each rank's levels) against the
  take-gather over the JAX `corner_indices_weights`: 1e-5;
- the port's dry run on 4 ranks (its three phases, finite losses);
- the NCCL rule, and a hung collective ending as RankTimeout.
Each launch has its own timeout (120 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops import raymarch as jrm
from seal3d_tpu.ops.hashgrid import HashGridConfig as JGrid
from seal3d_tpu.ops.hashgrid import corner_indices_weights as j_corners
from seal3d_tpu.ops.hashgrid import hashgrid_encode as j_encode
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as j_render_rays
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models.ngp import NGPConfig
from seal3d_tpu_torch.ops import raymarch as trm
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from seal3d_tpu_torch.parallel import programs
from seal3d_tpu_torch.parallel.launch import (RankTimeout, SharedDeviceError,
                                              launch)
from seal3d_tpu_torch.parallel.mesh import (find_batch_collectives,
                                            find_table_collectives)
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train.checkpoint import flatten_tree
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg

TIMEOUT = 120.0
OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05)
NUM_RAYS = 256
GRID = dict(bound=1.0, log2_hashmap_size=12, num_levels=4)
# dp2's params against the JAX Trainer's after 3 steps: Adam's normalised
# step moves an entry whose gradient is noise by up to lr either way, so an
# entry may be off by 2 lr a step; the share of entries off by more than
# 0.1 lr is held (measured <= 9.2e-5, the encoders; the MLPs none)
PARAM_ENTRY_TOL = 0.1    # of lr
PARAM_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the pack


def _candidates(n, c, frac, seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.1, 2.0, (n, c)), axis=1).astype(np.float32)
    dts = rng.uniform(0.001, 0.01, (n, c)).astype(np.float32)
    valid = rng.uniform(size=(n, c)) < frac
    ro = rng.normal(size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ts, dts, valid, ro, rd


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("budget", [4096, 512])   # under, over budget
def test_compact_flat_sharded_matches_jax(shards, budget):
    n, c, k = 64, 96, 24
    args = _candidates(n, c, 0.3, seed=shards + budget)
    j = jrm.compact_flat_sharded(jrm.compact_flat_direct,
                                 *map(jnp.asarray, args), k, budget, shards)
    t = trm.compact_flat_sharded(*map(torch.from_numpy, args), k, budget,
                                 shards)
    for name in ("ray_id", "valid", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in ("xyzs", "dirs", "deltas", "ts"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    if budget == 4096:   # under budget: the global pack's selection
        g = trm.compact_flat_direct(*map(torch.from_numpy, args), k, budget)
        assert sorted(t.ts[t.valid].tolist()) == sorted(g.ts[g.valid].tolist())


# ------------------------------------------------------ the dp train step


@pytest.fixture(scope="module")
def scene():
    ds = JScene().make_dataset(n_views=2, h=24, w=24, seed=0)
    occ = jocc.occupancy_update(jocc.occupancy_init(cascades=1),
                                JScene().density, jax.random.PRNGKey(2),
                                bound=1.0, density_thresh=0.01, full=True)
    return ds, occ


def _jax_trainer(scene):
    """The JAX Trainer with the settings a 2-device data mesh derives, its
    tables scaled up so that the encode drives the field, and the analytic
    occupancy."""
    ds, occ = scene
    opts = JOpts(**OPTS, flat_frac=0.5, pack_shards=2, march_two_level=False)
    jtr = JTrainer(jngp, jngp.NGPConfig(**GRID), opts,
                   JCfg(num_rays=NUM_RAYS, max_steps=100), dataset=ds,
                   key=jax.random.PRNGKey(0))
    jtr.init_state()
    p = jtr.state.params
    p = dict(p, encoder=p["encoder"] * 5e3,
             encoder_color=p["encoder_color"] * 5e3)
    jtr.state = jtr.state._replace(params=p, occ=occ)
    return jtr


def _spec(scene, jtr):
    ds, occ = scene
    return {"fcfg": NGPConfig(**GRID), "opts": TOpts(**OPTS, flat_frac=0.5),
            "tcfg": TCfg(num_rays=NUM_RAYS, max_steps=100),
            "dataset": NeRFDataset(poses=ds.poses, images=ds.images,
                                   intrinsics=ds.intrinsics, h=ds.h, w=ds.w),
            "params": jax.tree.map(np.asarray, jtr.state.params),
            "occ": [np.asarray(a) for a in occ]}


def _jax_draws(ds, key):
    """The StepRandom of the JAX step with `key` (its sample_batch's key
    splits), as numpy arrays."""
    kimg, kray, _, kjit = jax.random.split(key, 4)
    img_idx = jax.random.randint(kimg, (), 0, len(ds))
    rays = j_get_rays(kray, jnp.asarray(ds.poses)[img_idx],
                      jnp.asarray(ds.intrinsics), ds.h, ds.w, NUM_RAYS)
    return {"img_idx": np.asarray(img_idx).astype(np.int64),
            "inds": np.asarray(rays["inds"]).astype(np.int64), "bg": None,
            "jitter": np.asarray(jax.random.uniform(kjit, (NUM_RAYS,)))}


def test_pack_shards_step_matches_jax(scene):
    """pack_shards=2 without a mesh (compact_flat_sharded inside the
    renderer, the budget rounded to 128 * 2) against the JAX step."""
    ds, _ = scene
    jtr = _jax_trainer(scene)
    st = jtr.state
    key = jax.random.PRNGKey(11)
    r = _jax_draws(ds, key)
    _, kray, _, kjit = jax.random.split(key, 4)
    rays = j_get_rays(kray, jnp.asarray(ds.poses)[int(r["img_idx"])],
                      jnp.asarray(ds.intrinsics), ds.h, ds.w, NUM_RAYS)
    img = jnp.asarray(ds.images)[int(r["img_idx"])].reshape(ds.h * ds.w, -1)
    gt = jnp.take(img.astype(jnp.float32) / 255.0, rays["inds"], axis=0)

    def loss_fn(params):
        out = j_render_rays(params, jngp, jtr.fcfg, st.occ.bitfield,
                            rays["rays_o"], rays["rays_d"], jtr.opts,
                            key=kjit, bg_color=jnp.ones((NUM_RAYS, 3)),
                            perturb=True,
                            aabb=jtr._march_aabb(st.occ.occ_aabb))
        return ((out["image"] - gt) ** 2).mean(-1).mean(), out

    (jloss, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        st.params)
    spec = _spec(scene, jtr)
    spec["opts"] = dataclasses.replace(spec["opts"], pack_shards=2)
    ttr = programs.build_trainer(spec, torch.device("cpu"))
    rand = programs._step_random(r, torch.device("cpu"))
    tloss, tgrads, tout = ttr.loss_and_grads(
        ttr.state.params, ttr.state.occ, ttr.sample_batch(rand), rand.jitter)
    assert int(tout["num_samples"]) == int(jout["num_samples"]) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    jflat = dict(zip([k for k, _ in flatten_tree(tgrads)],
                     jax.tree.leaves(jgrads)))
    for k, v in flatten_tree(tgrads):
        ref = np.asarray(jflat[k])
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(v.numpy() / scale, ref / scale, atol=1e-2,
                                   err_msg=k)


def test_dp2_gloo_matches_jax_and_single_process(scene):
    ds, _ = scene
    jtr = _jax_trainer(scene)
    spec = _spec(scene, jtr)
    keys = [jax.random.PRNGKey(20 + s) for s in range(3)]
    jlosses = []
    with jax.disable_jit():   # eager: no FMA in the march start
        for key in keys:
            jtr.state, m = jtr._train_step(jtr.state, key)
            jlosses.append(float(m["loss"]))
    rands = [_jax_draws(ds, key) for key in keys]

    ranks = launch(programs.train_rank, 2,
                   args=(dict(spec, mesh=(2,), rands=rands),),
                   timeout=TIMEOUT)
    single = programs.train_rank(torch.device("cpu"), dict(
        spec, rands=rands, opts=TOpts(**OPTS, flat_frac=0.5, pack_shards=2)))
    for r in ranks:
        assert r["pack_shards"] == 2
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        assert r["num_samples"] == single["num_samples"]
        for k, v in single["params"].items():
            scale = float(np.abs(v).max())
            np.testing.assert_allclose(r["params"][k], v, atol=1e-5 * scale,
                                       err_msg=k)
        assert not find_batch_collectives(
            r["log"], NUM_RAYS * OPTS["num_candidates"] // 2)
        # one sum per MLP weight use before its bf16 rounding
        # (ops/mlp.py), then one of every other gradient, the loss and
        # the sample count: each gradient is summed once
        weights = sorted(v.size for k, v in single["params"].items()
                         if k.endswith("/w"))
        others = sum(v.size for k, v in single["params"].items()
                     if not k.endswith("/w"))
        assert [(c.what, c.elems) for c in r["log"]][-1] == (
            "grads", others + 2)
        assert sorted(c.elems for c in r["log"][:-1]) == weights
        assert {c.what for c in r["log"][:-1]} == {"mlp_grads"}
        # the params against the JAX Trainer's after the same steps
        lr = spec["tcfg"].lr
        for k, j in zip(single["params"], jax.tree.leaves(jtr.state.params)):
            diff = np.abs(r["params"][k] - np.asarray(j))
            assert diff.max() <= 2 * lr * len(keys), (k, diff.max())
            assert (diff > PARAM_ENTRY_TOL * lr).mean() <= PARAM_SHARE, (
                k, (diff > PARAM_ENTRY_TOL * lr).mean())
    # the replicas stay bit-identical
    assert ranks[0]["fingerprint"] == ranks[1]["fingerprint"]
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v)


def test_trainer_without_mesh_after_one_with_a_mesh(scene):
    """A rank builds a Trainer on a dp2 x tp2 mesh (xla, grid_shard_levels)
    and steps it, then a Trainer without a mesh, then the first again: the
    second logs nothing on the first's mesh, gives the one-process
    gradients (MLP weights bf16-exact, every leaf 1e-5 relative of the
    parent's run), and the first still exchanges over both axes."""
    jtr = _jax_trainer(scene)
    spec = dict(_spec(scene, jtr), steps=1,
                fcfg=NGPConfig(**GRID, grid_shard_levels=True),
                opts=TOpts(**OPTS, flat_frac=0.5, pack_shards=2))
    ranks = launch(programs.mesh_then_plain_rank, 4,
                   args=(dict(spec, mesh=(2, 2)),), timeout=TIMEOUT)
    single = programs.train_rank(torch.device("cpu"), spec)
    for r in ranks:
        assert r["ambient_none"]
        assert r["logged_on_mesh"] == []
        assert {c.axis for c in r["mesh_log"]} == {"data", "model"}
        for k, v in single["grads"].items():
            g = r["plain"]["grads"][k]
            assert np.linalg.norm(g - v) <= 1e-5 * np.linalg.norm(v), k
            if k.endswith("/w"):
                bf = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
                np.testing.assert_array_equal(g, bf, err_msg=k)


def test_tp_error_map_and_checkpoint(scene, tmp_path):
    """dp2 x tp2 on `xla` with grid_shard_levels and the error map: the
    per-ray errors of every rank refresh the same map as one process with
    pack_shards=2 (1e-6), the losses agree (1e-5 relative), and the
    checkpoint that rank 0 writes holds whole tables that load into a
    Trainer without a mesh (the ranks' joined params, exactly)."""
    jtr = _jax_trainer(scene)
    spec = dict(_spec(scene, jtr), steps=2, seed=3,
                fcfg=NGPConfig(**GRID, grid_shard_levels=True),
                tcfg=TCfg(num_rays=NUM_RAYS, max_steps=100, error_map=True))
    del spec["params"]
    path = str(tmp_path / "tp.npz")
    ranks = launch(programs.train_rank, 4, args=(dict(
        spec, mesh=(2, 2), save_to=path),), timeout=TIMEOUT)
    single = programs.train_rank(torch.device("cpu"), dict(
        spec, opts=TOpts(**OPTS, flat_frac=0.5, pack_shards=2)))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["error_map"], single["error_map"],
                                   atol=1e-6)
        assert (r["error_map"] != 0.1).any()
        assert {c.axis for c in r["log"]} == {"data", "model"}
        assert r["fingerprint"] == ranks[0]["fingerprint"]
    fresh = programs.build_trainer(spec, torch.device("cpu"))
    fresh.load_checkpoint(path)
    for k, v in flatten_tree(fresh.state.params):
        np.testing.assert_array_equal(v.numpy(), ranks[0]["params"][k],
                                      err_msg=k)


def test_dnerf_dp2_matches_single_process(scene):
    """D-NeRF over two gloo ranks (its batch sharded as the JAX trainer
    shards it; time and the sigma_reg points whole on every rank) against
    one process with pack_shards=2: losses 1e-5 relative, the first step's
    gradients 1e-5 relative (L2, each leaf), the params' mean |diff| after
    the steps 1e-3 of their mean |change| (summation order only, on the
    CPU; Adam's normalised step lets an entry whose gradient is nearly 0
    move by more than its gradient's error)."""
    from seal3d_tpu_torch.data.synthetic import DynamicSyntheticScene
    from seal3d_tpu_torch.models.dnerf import DNeRFConfig

    ds = DynamicSyntheticScene().make_dataset(n_views=4, h=16, w=16, seed=0,
                                              views_per_time=2)
    occ, slices = scene[1], 4   # the static scene's occupancy in each slice
    spec = {"fcfg": DNeRFConfig(bound=1.0, log2_hashmap_size=12,
                                num_layers_time=3, hidden_dim_time=32,
                                time_multires=2),
            "opts": TOpts(**OPTS, flat_frac=0.5),
            "tcfg": TCfg(num_rays=NUM_RAYS, max_steps=100, random_bg=False),
            "dataset": ds, "steps": 2,
            "occ": [np.stack([np.asarray(occ.density_grid)] * slices),
                    np.stack([np.asarray(occ.bitfield)] * slices),
                    np.asarray(occ.mean_density),
                    np.asarray(occ.iter_density)],
            "dnerf": dict(time_size=slices, deform_reg=1e-3,
                          sigma_reg=1e-3)}
    ranks = launch(programs.train_rank, 2, args=(dict(spec, mesh=(2,)),),
                   timeout=TIMEOUT)
    single = programs.train_rank(torch.device("cpu"), dict(
        spec, opts=TOpts(**OPTS, flat_frac=0.5, pack_shards=2)))
    assert min(single["num_samples"]) > 0
    for r in ranks:
        assert r["pack_shards"] == 2
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        for k, v in single["grads"].items():
            assert np.linalg.norm(r["grads"][k] - v) <= 1e-5 * max(
                np.linalg.norm(v), 1e-30), k
        diff = np.mean(np.concatenate([np.abs(r["params"][k] - v).ravel()
                                       for k, v in single["params"].items()]))
        assert diff <= 1e-3 * single["moved"]


# ---------------------------------------------------- the level-sharded encode


def _sharded_encode(cfg_kw, mesh, m, f, seed, valid_frac=None):
    """-> (the spec's table, x, valid and the ranks' results, gathered:
    out [M, L*F] from model rank 0 of each data row, grad [L*T, F] from
    data rank 0 of each model column)."""
    tcfg = TGrid(**cfg_kw)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (tcfg.total_params, f)).astype(np.float32)
    x = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    valid = None if valid_frac is None else rng.uniform(size=m) < valid_frac
    return tcfg, table, x, valid


def _gather(ranks, n_data, n_model):
    by = {r["coords"]: r for r in ranks}
    out = np.concatenate([by[(i, 0)]["out"] for i in range(n_data)])
    grad = np.concatenate([by[(0, j)]["grad"] for j in range(n_model)])
    for (i, j), r in by.items():   # every replica agrees
        np.testing.assert_array_equal(r["out"], by[(i, 0)]["out"])
        np.testing.assert_array_equal(r["grad"], by[(0, j)]["grad"])
    return out, grad


def test_tp_xla_matches_jax():
    """tests/test_parallel.py's case under make_mesh_2d(2, 2)."""
    kw = dict(num_levels=8, level_dim=2, base_resolution=16,
              log2_hashmap_size=10, desired_resolution=128,
              shard_levels=True)
    tcfg, table, x, _ = _sharded_encode(kw, (2, 2), 64, 2, seed=0)
    jcfg = JGrid(**kw)
    ref = np.asarray(j_encode(jnp.asarray(table), jnp.asarray(x), jcfg))
    ref_grad = np.asarray(jax.grad(lambda t: (j_encode(t, jnp.asarray(x),
                                                       jcfg) ** 2).sum())(
        jnp.asarray(table)))
    ranks = launch(programs.encode_rank, 4, args=(dict(
        cfg=tcfg, mesh=(2, 2), table=table, x=x, g=2.0 * ref),),
        timeout=TIMEOUT)
    out, grad = _gather(ranks, 2, 2)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-6)
    for r in ranks:
        assert not find_table_collectives(r["log"], tcfg.total_params, 2)
        assert {(c.axis, c.what) for c in r["log"]} == {
            ("model", "features"), ("data", "grads")}


def test_tp_halo_matches_take_oracle():
    """K1's plain version over each rank's levels (1 x 2 ranks) against
    the fp32 take-gather over the JAX corner_indices_weights."""
    kw = dict(num_levels=8, level_dim=2, base_resolution=16,
              log2_hashmap_size=12, desired_resolution=128,
              gridtype="wrap", backend="halo", shard_levels=True)
    tcfg, table, x, valid = _sharded_encode(kw, (1, 2), 96, 4, seed=1,
                                            valid_frac=0.8)
    g = np.random.default_rng(2).uniform(-1, 1, (96, 8 * 4)).astype(
        np.float32)

    def oracle(tab):
        idx, w = j_corners(jnp.asarray(x), JGrid(**kw))
        feats = jnp.take(tab, idx.reshape(96, -1), axis=0).reshape(
            96, 8, 8, -1)
        out = (feats * w[..., None]).sum(axis=2).reshape(96, -1)
        return jnp.where(jnp.asarray(valid)[:, None], out, 0.0)

    ref = np.asarray(oracle(jnp.asarray(table)))
    ref_grad = np.asarray(jax.grad(lambda t: (oracle(t) * g).sum())(
        jnp.asarray(table)))
    ranks = launch(programs.encode_rank, 2, args=(dict(
        cfg=tcfg, mesh=(1, 2), table=table, x=x, valid=valid, g=g),),
        timeout=TIMEOUT)
    out, grad = _gather(ranks, 1, 2)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5)
    for r in ranks:
        assert not find_table_collectives(r["log"], tcfg.total_params, 2)


# ----------------------------------------------------- dry run, launcher


def test_dryrun_four_ranks():
    from seal3d_tpu_torch.dryrun import dryrun_multichip

    results = dryrun_multichip(4, device="cpu", timeout=TIMEOUT,
                               full_grid=False)
    assert len(results) == 4
    tags = [t for t, _, _ in results[0]]
    assert tags == ["dp, no-batch-collectives", "dp2 x tp2",
                    "dp2 x tp2, halo/-O"]
    for r in results:
        assert all(np.isfinite(loss) for _, loss, _ in r)
        # the data replicas of a phase agree on the loss
        assert [loss for _, loss, _ in r] == [loss for _, loss, _ in
                                              results[0]]


def test_launcher_refuses_nccl_on_a_shared_card_and_times_out():
    with pytest.raises(SharedDeviceError, match="a card per rank"):
        launch(programs.unmatched_collective_rank, 2, args=(1.0,),
               backend="nccl", device="cpu")
    with pytest.raises(RankTimeout, match="did not finish within 8 s"):
        launch(programs.unmatched_collective_rank, 2, args=(60.0,),
               timeout=8.0)
