"""Port parity of the ladder kernel K4 on the CPU: `ladder_plan_plain` (the
plain PyTorch version the CUDA kernel is held against on the card) against
the JAX package's Pallas `ladder_plan` run interpreted, against the port's
own `group_plan`, and through `render_rays` and the trainer's demand probe.

Setup of tests/test_ladder_kernel.py: one 24x24 view of the analytic scene,
its occupancy bitfield, the -O eval point (max_steps 512, 256 candidates,
group 4, 32 coarse steps, pool 64). The interpreted kernel runs under
jax.jit, whose FMA contraction can move a borderline group across a cell:
keep may differ in < 1e-3 of the entries (the reference's own bound);
against the port's eager `group_plan` it is exact. Other statics (coarse
steps and group counts that are not multiples of a warp, both pooled views)
on the rays of tests/test_torch_ladder_cuda.py go against the JAX package's
eager XLA `group_plan`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_full_rays
from seal3d_tpu.data.synthetic import SyntheticScene
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops import raymarch as jrm
from seal3d_tpu.ops.pallas import ladder as jladder
from seal3d_tpu.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as jrender_rays
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.ops import ladder as tladder
from seal3d_tpu_torch.ops import raymarch as trm
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.render.renderer import render_rays as trender_rays
from seal3d_tpu_torch.train.checkpoint import params_from_jax
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from seal3d_tpu_torch.train.trainer import Trainer as TTrainer
from test_torch_ladder_cuda import STATICS, static_rays


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

KW = dict(bound=1.0, max_steps=512, num_candidates=256, group=4,
          min_near=0.05, pool=64)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    scene = SyntheticScene()
    ds = scene.make_dataset(n_views=1, h=24, w=24, seed=5)
    occ = occupancy_update(occupancy_init(cascades=1), scene.density,
                           jax.random.PRNGKey(0), bound=1.0,
                           density_thresh=0.01, full=True)
    rays = get_full_rays(jnp.asarray(ds.poses[0]), jnp.asarray(ds.intrinsics),
                         ds.h, ds.w)
    ro, rd = np.array(rays["rays_o"]), np.array(rays["rays_d"])
    # a render pad ray (behind the box: a degenerate interval, not a miss),
    # a ray that misses the slabs, and one from inside the box
    ro[-3:] = [[3.0, 0, 0], [3.0, 0, 0], [0.1, 0.0, 0.05]]
    rd[-3:] = [[1.0, 0, 0], [0.0, 1.0, 0], [0.0, 0.6, 0.8]]
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    return ds, np.asarray(occ.bitfield), ro, rd, aabb


def test_pack_tables_bit_for_bit(setup):
    _, bf, *_ = setup
    for pool in (32, 64):
        jc, jp, jf = jladder.pack_tables(jnp.asarray(bf), pool=pool)
        tc, tp, tf = tladder.pack_tables(_t(bf), pool=pool)
        # JAX: one f32 0/1 per coarse cell; f32 byte values for the others
        np.testing.assert_array_equal(
            np.unpackbits(tc.numpy(), bitorder="little"),
            np.asarray(jc).reshape(-1).astype(np.uint8))
        np.testing.assert_array_equal(
            tp.numpy(), np.asarray(jp).reshape(-1).astype(np.uint8))
        np.testing.assert_array_equal(
            tf.numpy(), np.asarray(jf).reshape(-1).astype(np.uint8))
    with pytest.raises(ValueError, match="single-cascade"):
        tladder.pack_tables(torch.zeros(2 * len(bf), dtype=torch.uint8))


def test_plain_matches_interpreted_pallas_kernel(setup):
    _, bf, ro, rd, aabb = setup
    tabs = jladder.pack_tables(jnp.asarray(bf), pool=64)
    jt0, jfar, jkeep, jcnt = jladder.ladder_plan(
        jnp.asarray(ro), jnp.asarray(rd), *tabs, jnp.asarray(aabb),
        n_coarse=32, **KW)
    t0, far, keep, cnt = tladder.ladder_plan(
        _t(ro), _t(rd), *tladder.pack_tables(_t(bf), 64), _t(aabb),
        n_coarse=32, **KW)
    assert keep.dtype == torch.bool and keep.shape == (len(ro), 64)
    np.testing.assert_allclose(t0.numpy(), np.asarray(jt0), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(far.numpy(), np.asarray(jfar), rtol=1e-6,
                               atol=1e-6)
    mism = keep.numpy() != np.asarray(jkeep)
    assert mism.mean() < 1e-3, mism.mean()
    np.testing.assert_allclose(cnt.numpy().sum(), np.asarray(jcnt).sum(),
                               rtol=1e-3)
    assert 0 < int(keep.sum()) < keep.numel()
    # the pad ray and the missing ray are inert; the miss reads 1e9
    assert not keep[-3:-1].any() and float(cnt[-3:-1].sum()) == 0.0
    assert float(t0[-2]) == 1e9 and float(far[-2]) == 1e9


def test_plain_equals_group_plan_and_bounds_the_fine_repack(setup):
    _, bf, ro, rd, aabb = setup
    plan = trm.group_plan(_t(ro), _t(rd), _t(bf), cascades=1, k=48,
                          aabb=_t(aabb), coarse_steps=32, kg=-1, **KW)
    kplan, cnt = tladder.ladder_plan_kernel(
        _t(ro), _t(rd), _t(bf), 1.0, 512, 256, 4, 0.05, _t(aabb), 32, 64)
    assert torch.equal(kplan.keep, plan.keep)
    assert torch.equal(kplan.t0, plan.t0) and torch.equal(kplan.fars, plan.fars)
    assert torch.equal(kplan.stride, plan.stride)
    budget = 24 * 24 * 48
    mf = trm.pack_groups_expand_fine(plan, plan.keep, 0, _t(ro), _t(rd),
                                     _t(bf), 1.0, 1, 4, budget, budget, 4)
    true_kept, bound_cnt = int(mf.valid.sum()), float(cnt.sum())
    assert true_kept <= bound_cnt <= true_kept * 1.35 + 64, (bound_cnt,
                                                             true_kept)


@pytest.mark.parametrize("pool", [32, 64])
@pytest.mark.parametrize("n_coarse,cg", STATICS)
def test_plain_statics_against_jax_group_plan(setup, n_coarse, cg, pool):
    """t0, far and keep of the plain version against the JAX package's XLA
    group_plan (kg=-1, coarse_steps=n_coarse), run eagerly, on rays from
    outside, rays that miss, rays from inside the box and axis-aligned
    rays; the demand bounds what the fine repack keeps, ray by ray.

    K4 places coarse step i at near + (i + 0.5) * ((far - near) / n), the
    XLA path at near + ((i + 0.5) / n) * (far - near): the same number when
    n is a power of two, an ulp apart otherwise, which moves a step across
    a coarse cell on a few rays (and their t0 or far by one coarse step).
    So: equal everywhere at n = 32; elsewhere t0 and far equal on all but
    0.5% of the rays, and keep equal on the rays whose t0 and far are."""
    _, bf, *_ = setup
    ro, rd = static_rays(2000, seed=n_coarse + pool)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    kw = dict(KW, num_candidates=4 * cg, pool=pool)
    j = jrm.group_plan(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(bf),
                       cascades=1, k=48, aabb=jnp.asarray(aabb),
                       coarse_steps=n_coarse, kg=-1, **kw)
    t0, far, keep, cnt = tladder.ladder_plan(
        _t(ro), _t(rd), *tladder.pack_tables(_t(bf), pool), _t(aabb),
        n_coarse=n_coarse, **kw)
    same = (t0.numpy() == np.asarray(j.t0)) & (far.numpy()
                                              == np.asarray(j.fars))
    assert same.all() if n_coarse == 32 else same.mean() >= 0.995, \
        same.mean()
    np.testing.assert_array_equal(keep.numpy()[same], np.asarray(j.keep)[same])
    miss = t0.numpy() == 1e9
    assert miss.sum() >= len(ro) // 4 and not keep.numpy()[miss].any()
    assert 0 < int(keep.sum()) < keep.numel()
    plan = trm.GroupPlan(t0=t0, fars=far, keep=keep,
                         stride=torch.ones(len(ro), dtype=torch.int64),
                         dt_min=2.0 * tladder.SQRT3 / KW["max_steps"])
    budget = len(ro) * 4 * cg      # no thinning
    mf = trm.pack_groups_expand_fine(plan, keep, 0, _t(ro), _t(rd), _t(bf),
                                     1.0, 1, 4, budget, budget, 4)
    kept = torch.zeros(len(ro)).index_add_(
        0, mf.ray_id[mf.valid].long(), torch.ones(int(mf.valid.sum())))
    assert bool((kept <= cnt).all()) and float(kept.sum()) > 0


def test_wrapper_refuses_other_devices_and_bad_statics(setup):
    _, bf, ro, rd, aabb = setup
    tabs = tladder.pack_tables(_t(bf), 64)
    with pytest.raises(ValueError, match="unsupported device"):
        tladder.ladder_plan(torch.zeros(4, 3, device="meta"),
                            torch.zeros(4, 3, device="meta"), *tabs,
                            _t(aabb), n_coarse=32, **KW)
    with pytest.raises(ValueError, match="divide into groups"):
        tladder.ladder_plan(_t(ro), _t(rd), *tabs, _t(aabb), n_coarse=32,
                            **dict(KW, group=3))
    before = tladder.ladder_plan.launches
    tladder.ladder_plan(_t(ro), _t(rd), *tabs, _t(aabb), n_coarse=32, **KW)
    assert tladder.ladder_plan.launches == before  # CPU: plain, no launch


class _JSceneField:
    @staticmethod
    def apply(params, cfg, x, d, valid=None):
        return cfg.density(x), cfg.color(x, d)


class _TSceneField:
    @staticmethod
    def apply(params, cfg, x, d, valid=None):
        return cfg.density(x), cfg.color(x, d)


def test_render_rays_tl_kernel_on_off_and_against_jax(setup):
    """tests/test_ladder_kernel.py::test_kernel_render_matches_xla_two_level
    in the port, and the port's kernel-branch render against the JAX one."""
    from seal3d_tpu_torch.data.synthetic import SyntheticScene as TScene

    _, bf, ro, rd, _ = setup
    base = dict(bound=1.0, dt_gamma=0.0, max_steps=256, budget_per_ray=32,
                num_candidates=64, min_near=0.05, occ_stride=4,
                coarse_steps=32, flat_frac=0.5, march_two_level=True,
                tl_group=4, tl_pool=32, tl_kg=-1, tl_over=2.0)
    off, on = TOpts(**base, tl_kernel=False), TOpts(**base, tl_kernel=True)
    assert off.two_level_ok(32) and on.tl_kernel_ok(32, None)
    assert not on.tl_kernel_ok(32, torch.zeros(3))
    out_x = trender_rays(None, _TSceneField, TScene(), _t(bf), _t(ro), _t(rd),
                         off, bg_color=1.0)
    out_k = trender_rays(None, _TSceneField, TScene(), _t(bf), _t(ro), _t(rd),
                         on, bg_color=1.0)
    np.testing.assert_allclose(out_k["image"].numpy(), out_x["image"].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out_k["depth"].numpy(), out_x["depth"].numpy(),
                               atol=1e-4)
    assert int(out_k["num_samples"]) == int(out_x["num_samples"]) > 0
    out_j = jrender_rays(None, _JSceneField, SyntheticScene(), jnp.asarray(bf),
                         jnp.asarray(ro), jnp.asarray(rd),
                         JOpts(**base, tl_kernel=True), bg_color=1.0)
    np.testing.assert_allclose(out_k["image"].numpy(),
                               np.asarray(out_j["image"]), atol=2e-3)
    np.testing.assert_allclose(out_k["depth"].numpy(),
                               np.asarray(out_j["depth"]), atol=2e-3)


def test_eval_demand_kernel_branch_and_render_image(setup):
    """The trainer's demand probe through the kernel branch against its
    closed-form branch (fine demand >=, kept groups equal), pad rays masked
    by n_valid; render_image with tl_kernel equals render_image without."""
    ds, bf, ro, rd, aabb = setup
    kw = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
              grid_backend="halo", gridtype="wrap")
    opts = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
                num_candidates=256, min_near=0.05, occ_stride=4,
                coarse_steps=64)
    cfg = dict(eval_chunk=256, eval_budget_per_ray=48, eval_flat_frac=0.5)
    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    params = params_from_jax(jax.tree.map(
        np.asarray, jngp.init(jax.random.PRNGKey(3), jngp.NGPConfig(**kw))))
    params["encoder"] = params["encoder"] * 5e3
    trainers = {}
    for on in (False, True):
        tr = TTrainer(tngp, tngp.NGPConfig(**kw), TOpts(**opts, tl_kernel=on),
                      TCfg(**cfg), dataset=tds, device="cpu")
        tr.init_state()
        tr.state = tr.state._replace(
            ema_params=params, occ=tr.state.occ._replace(bitfield=_t(bf)))
        trainers[on] = tr
    assert trainers[True].eval_opts.tl_kernel_ok(48, None)
    assert not trainers[False].eval_opts.tl_kernel_ok(48, None)
    aabb = trainers[True]._march_aabb(trainers[True].state.occ.occ_aabb)
    for n_valid in (len(ro), 300):
        d_k = trainers[True]._eval_demand(_t(bf), _t(ro), _t(rd), aabb,
                                          n_valid)
        d_x = trainers[False]._eval_demand(_t(bf), _t(ro), _t(rd), aabb,
                                           n_valid)
        assert int(d_k[1]) == int(d_x[1]) > 0
        assert int(d_k[0]) >= int(d_x[0]) > 0
    full = trainers[True]._eval_demand(_t(bf), _t(ro), _t(rd), aabb,
                                       len(ro))
    assert int(d_k[1]) < int(full[1])   # n_valid masked rays out
    img_k, dep_k = trainers[True].render_image(ds.poses[0], ds.h, ds.w)
    img_x, dep_x = trainers[False].render_image(ds.poses[0], ds.h, ds.w)
    np.testing.assert_allclose(img_k.numpy(), img_x.numpy(), atol=1e-5)
    np.testing.assert_allclose(dep_k.numpy(), dep_x.numpy(), atol=1e-4)
    sk, sx = trainers[True].render_stats[-1], trainers[False].render_stats[-1]
    assert sk["samples"] == sx["samples"] > 0
    assert sk["chunks_rendered"] == sx["chunks_rendered"] >= 1


def test_trainer_device_none_is_not_the_cpu():
    """`Trainer(device=None)` means the card: it raises where there is none
    instead of coming up on the CPU."""
    if torch.cuda.is_available():
        tr = TTrainer(tngp, tngp.NGPConfig(), TOpts(), TCfg())
        assert tr.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTrainer(tngp, tngp.NGPConfig(), TOpts(), TCfg())
    assert TTrainer(tngp, tngp.NGPConfig(), TOpts(), TCfg(),
                    device="cpu").device.type == "cpu"
