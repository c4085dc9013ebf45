"""Port parity of the single-level eval render: the demand probe that picks
each chunk's bucket, `Trainer.render_image` with `eval_two_level=False` at
bound 1 and bound 2, and the `.npz` round trip of a two-cascade state.

The demand probe's counts are held exactly against the same formula over
the reference's `march_candidates`, run eagerly (inside `jax.jit` XLA:CPU
contracts a*b+c into FMAs, which moves a candidate by an ulp). The renders
compare with the reference's jitted `render_image` on the `xla` backend
(fp32 gathers) at the -O eval point scaled down (4 levels at T=2^12,
256-ray chunks, 24x24 views), as tests/test_torch_render_slice.py does:
within 1e-4, each chunk under its budget cap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_full_rays as j_full_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.data.synthetic import WideSyntheticScene as JWide
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops import raymarch as jrm
from seal3d_tpu.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.checkpoint import params_from_jax
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


# bound -> (scene, the train options of the -O point at that bound)
POINTS = {
    1.0: (JScene, dict(bound=1.0, dt_gamma=0.0, max_steps=512,
                       num_candidates=256, coarse_steps=64, occ_stride=4,
                       min_near=0.05)),
    2.0: (JWide, dict(bound=2.0, dt_gamma=1 / 128, max_steps=512,
                      num_candidates=256, coarse_steps=64, occ_stride=4,
                      min_near=0.05)),
}
# the single-level fixed-budget eval of bench.py's parity check, adaptive
TCFG = dict(eval_chunk=256, eval_budget_per_ray=48, eval_flat_frac=0.375,
            eval_two_level=False, eval_adaptive=True, eval_tile_chunks=True)
CACHE = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(bound):
    """(dataset, reference occupancy of the analytic scene) at a bound."""
    if bound not in CACHE:
        scene_cls, _ = POINTS[bound]
        cascades = 1 if bound == 1.0 else 2
        ds = scene_cls().make_dataset(n_views=2, h=24, w=24, seed=0)
        occ = occupancy_update(occupancy_init(cascades, bound=bound),
                               scene_cls().density, jax.random.PRNGKey(2),
                               bound=bound, density_thresh=0.01, full=True)
        CACHE[bound] = ds, occ
    return CACHE[bound]


def _trainers(bound, **tcfg):
    """A JAX and a port trainer with the same EMA params (JAX init, tables
    scaled up so the encode drives the field) and the analytic occupancy."""
    ds, occ = _scene(bound)
    _, opts = POINTS[bound]
    kw = dict(bound=bound, log2_hashmap_size=12, num_levels=4,
              grid_backend="xla", gridtype="hash")
    cfg = dict(TCFG, **tcfg)
    jtr = JTrainer(jngp, jngp.NGPConfig(**kw), JOpts(**opts), JCfg(**cfg),
                   dataset=ds, key=jax.random.PRNGKey(0))
    jtr.init_state()
    ema = jtr.state.ema_params
    ema = dict(ema, encoder=ema["encoder"] * 5e3,
               encoder_color=ema["encoder_color"] * 5e3)
    jtr.state = jtr.state._replace(ema_params=ema, occ=occ)
    ttr = TTrainer(tngp, tngp.NGPConfig(**kw), TOpts(**opts), TCfg(**cfg),
                   dataset=NeRFDataset(poses=ds.poses, images=ds.images,
                                       intrinsics=ds.intrinsics, h=ds.h,
                                       w=ds.w), device="cpu")
    ttr.init_state()
    ttr.state = ttr.state._replace(
        ema_params=params_from_jax(jax.tree.map(np.asarray, ema)),
        occ=ttr.state.occ._replace(
            bitfield=_t(occ.bitfield), occ_aabb=_t(occ.occ_aabb)))
    return jtr, ttr


def _view_rays(bound, n_pad):
    """The 576 rays of view 1, the last n_pad of them replaced by the pad
    convention of render_image (from (3 bound, 0, 0), pointing +x)."""
    ds, _ = _scene(bound)
    r = j_full_rays(jnp.asarray(ds.poses[1]), jnp.asarray(ds.intrinsics),
                    24, 24)
    ro, rd = np.array(r["rays_o"]), np.array(r["rays_d"])
    if n_pad:
        ro[-n_pad:] = [3.0 * bound, 0.0, 0.0]
        rd[-n_pad:] = [1.0, 0.0, 0.0]
    return ro, rd


@pytest.mark.parametrize("bound", [1.0, 2.0])
@pytest.mark.parametrize("n_pad", [0, 100])
def test_single_level_demand(bound, n_pad):
    """(kept candidates under the per-ray stride cap, 0 groups) of a chunk,
    pad rays masked out, equal to the formula over eager JAX. At budget 16
    a ray, so that rays reach the cap at both bounds."""
    ek = 16
    _, ttr = _trainers(bound, eval_budget_per_ray=ek)
    assert not ttr._eval_tl_uncapped
    ds, occ = _scene(bound)
    eo = ttr.eval_opts
    ro, rd = _view_rays(bound, n_pad)
    n_valid = ro.shape[0] - n_pad
    aabb = ttr._march_aabb(ttr.state.occ.occ_aabb)
    _, _, valid = jrm.march_candidates(
        jnp.asarray(ro), jnp.asarray(rd), occ.bitfield, eo.bound,
        eo.cascades, eo.dt_gamma, eo.max_steps, eo.num_candidates,
        min_near=eo.min_near, aabb=jnp.asarray(aabb.numpy()),
        occ_stride=eo.occ_stride, coarse_steps=eo.coarse_steps)
    valid = np.array(valid)
    valid[n_valid:] = False
    rank = np.cumsum(valid, axis=1)
    stride = np.maximum(np.ceil(rank[:, -1:] / ek).astype(np.int64), 1)
    want = int((valid & ((rank - 1) % stride == 0)).sum())
    got = ttr._eval_demand(ttr.state.occ.bitfield, _t(ro), _t(rd), aabb,
                           n_valid)
    assert got.tolist() == [want, 0]
    assert 0 < want < int(valid.sum())    # some rays hit the stride cap
    if n_pad:   # the pad rays alone demand nothing
        alone = ttr._eval_demand(ttr.state.occ.bitfield, _t(ro[-n_pad:]),
                                 _t(rd[-n_pad:]), aabb, n_pad)
        assert alone.tolist() == [0, 0]


def test_uncapped_two_level_demand_without_closed_form():
    """The two-level eval with groups tested at another stride than their
    own (occ_stride 2, group 4): the uncapped ladder's valid count and
    group_plan's kept groups, each equal to eager JAX's."""
    jtr, ttr = _trainers(1.0, eval_two_level=True, eval_tl_kg=-1)
    ttr.eval_opts = dataclasses.replace(ttr.eval_opts, occ_stride=2)
    eo = ttr.eval_opts
    assert ttr._eval_tl_uncapped and eo.occ_stride != eo.tl_group
    _, occ = _scene(1.0)
    ro, rd = _view_rays(1.0, 50)
    aabb = ttr._march_aabb(ttr.state.occ.occ_aabb)
    ja = jnp.asarray(aabb.numpy())
    _, _, valid = jrm.march_candidates(
        jnp.asarray(ro), jnp.asarray(rd), occ.bitfield, 1.0, 1, 0.0,
        eo.max_steps, eo.num_candidates, min_near=eo.min_near, aabb=ja,
        occ_stride=2, coarse_steps=eo.coarse_steps)
    plan = jrm.group_plan(jnp.asarray(ro), jnp.asarray(rd), occ.bitfield,
                          bound=1.0, cascades=1, max_steps=eo.max_steps,
                          k=48, num_candidates=eo.num_candidates,
                          group=eo.tl_group, min_near=eo.min_near, aabb=ja,
                          coarse_steps=eo.coarse_steps, kg=-1,
                          pool=eo.tl_pool)
    n_valid = ro.shape[0] - 50
    want = [int(np.asarray(valid)[:n_valid].sum()),
            int(np.asarray(plan.keep)[:n_valid].sum())]
    got = ttr._eval_demand(ttr.state.occ.bitfield, _t(ro), _t(rd), aabb,
                           n_valid)
    assert got.tolist() == want and min(want) > 0


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_render_image_single_level(bound):
    ds, _ = _scene(bound)
    jtr, ttr = _trainers(bound)
    assert not ttr.eval_opts.two_level_ok(48)
    ji, jd = jtr.render_image(ds.poses[0], 24, 24)
    ti, td = ttr.render_image(ds.poses[0], 24, 24)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    st = ttr.render_stats[-1]
    assert st["chunks_rendered"] >= 1 and st["samples"] > 0, st
    assert max(st["buckets"]) <= 0.375, st    # capped at eval_flat_frac
    assert float(ti.std()) > 0.05             # the object is in view


def test_two_cascade_state_npz_round_trip(tmp_path):
    """A bound-2 state (density_grid [2, 2^21], bitfield [2 * 2^21 / 8])
    written by the port loads back bit for bit into the port and into the
    reference's TrainState."""
    jtr, ttr = _trainers(2.0)
    rng = np.random.default_rng(0)
    grid = rng.uniform(-1, 1, (2, 2**21)).astype(np.float32)
    occ = ttr.state.occ._replace(density_grid=_t(grid),
                                 iter_density=torch.tensor(5,
                                                           dtype=torch.int32))
    ttr.state = ttr.state._replace(occ=occ)
    assert tuple(occ.bitfield.shape) == (2 * 2**21 // 8,)
    path = ttr.save_checkpoint(str(tmp_path / "ngp_b2.npz"))
    fresh = TTrainer(ttr.field, ttr.fcfg, ttr.opts, ttr.cfg, device="cpu")
    fresh.load_checkpoint(path)
    loaded_port = dict(tckpt.flatten_tree(fresh.state))
    for k, a in tckpt.flatten_tree(ttr.state):
        assert torch.equal(a, loaded_port[k]), k
    loaded = jckpt.load_state(path, jtr.state)
    np.testing.assert_array_equal(np.asarray(loaded.occ.density_grid), grid)
    np.testing.assert_array_equal(np.asarray(loaded.occ.bitfield),
                                  occ.bitfield.numpy())
    assert int(loaded.occ.iter_density) == 5
