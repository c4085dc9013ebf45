"""Port parity of the two-level eval march, at the -O eval point scaled to a
small ray batch: N=512, C=256, max_steps 512, coarse 32, group 4, pool 64,
kg -1, over 2.5, over an occupancy bitfield of the analytic scene.

The JAX functions run eagerly here, op by op, as the port does: inside
`jax.jit` XLA:CPU contracts a*b+c into FMAs, which moves positions by an ulp
and can move a sample across a cell boundary. Integer outputs (kept groups,
valid slots, offsets, counts, ray ids) must then be exact, floats within
1e-6 on valid slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.provider import rand_poses
from seal3d_tpu.data.rays import get_full_rays
from seal3d_tpu.data.synthetic import SyntheticScene
from seal3d_tpu.ops import raymarch as jrm
from seal3d_tpu.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu_torch.ops import raymarch as trm

EVAL = dict(bound=1.0, cascades=1, max_steps=512, k=48, num_candidates=256,
            group=4, min_near=0.05, coarse_steps=32, kg=-1, pool=64)


@pytest.fixture(scope="module")
def scene_inputs():
    occ = occupancy_update(occupancy_init(cascades=1), SyntheticScene().density,
                           jax.random.PRNGKey(2), bound=1.0,
                           density_thresh=0.01, full=True)
    pose = rand_poses(np.random.default_rng(5), 1, radius=2.2,
                      theta_range=(30, 120))[0]
    intr = np.array([18.0, 18.0, 16.0, 8.0], np.float32)
    rays = get_full_rays(jnp.asarray(pose), jnp.asarray(intr), 16, 32)
    ro, rd = np.array(rays["rays_o"]), np.array(rays["rays_d"])
    # two pad-convention rays (miss the box) and one from inside it
    ro[-3:] = [[3.0, 0, 0], [3.0, 0, 0], [0.1, 0.0, 0.05]]
    rd[-3:] = [[1.0, 0, 0], [1.0, 0, 0], [0.0, 0.6, 0.8]]
    bf = np.asarray(occ.bitfield)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    return ro, rd, bf, aabb


def _t(a):
    return torch.from_numpy(np.array(a))


def test_near_far_coarse_and_pooled_view(scene_inputs):
    ro, rd, bf, aabb = scene_inputs
    jn, jf = jrm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.asarray(aabb), 0.05)
    tn, tf = trm.near_far_from_aabb(_t(ro), _t(rd), _t(aabb), 0.05)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    jn2, jf2 = jrm.coarse_tighten(jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.asarray(bf), jn, jf, 1, 1.0, n_steps=32,
                                  max_steps=512)
    tn2, tf2 = trm.coarse_tighten(_t(ro), _t(rd), _t(bf), tn, tf, 1, 1.0,
                                  n_steps=32)
    np.testing.assert_allclose(tn2.numpy(), np.asarray(jn2), atol=1e-6)
    np.testing.assert_allclose(tf2.numpy(), np.asarray(jf2), atol=1e-6)
    for pool in (32, 64):
        np.testing.assert_array_equal(
            trm.pooled_dilated(_t(bf), 1, pool).numpy(),
            np.asarray(jrm.pooled_dilated(jnp.asarray(bf), 1, pool)))


def test_group_plan_exact(scene_inputs):
    ro, rd, bf, aabb = scene_inputs
    j = jrm.group_plan(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(bf),
                       aabb=jnp.asarray(aabb), **EVAL)
    t = trm.group_plan(_t(ro), _t(rd), _t(bf), aabb=_t(aabb), **EVAL)
    np.testing.assert_array_equal(t.keep.numpy(), np.asarray(j.keep))
    np.testing.assert_array_equal(t.stride.numpy(), np.asarray(j.stride))
    np.testing.assert_allclose(t.t0.numpy(), np.asarray(j.t0), atol=1e-6)
    np.testing.assert_allclose(t.fars.numpy(), np.asarray(j.fars), atol=1e-6)
    assert t.dt_min == j.dt_min
    assert 0 < int(t.keep.sum()) < t.keep.numel()


def _march_both(scene_inputs, budget):
    ro, rd, bf, aabb = scene_inputs
    kw = dict(EVAL, budget=budget, occ_stride=4, over=2.5)
    j = jrm.march_rays_flat_2level(jnp.asarray(ro), jnp.asarray(rd),
                                   jnp.asarray(bf), aabb=jnp.asarray(aabb), **kw)
    t = trm.march_rays_flat_2level(_t(ro), _t(rd), _t(bf), aabb=_t(aabb), **kw)
    return j, t


def _assert_same_pack(j, t):
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.ray_id.numpy()[jv], np.asarray(j.ray_id)[jv])
    for k in ("xyzs", "dirs", "deltas", "ts"):
        np.testing.assert_allclose(getattr(t, k).numpy()[jv],
                                   np.asarray(getattr(j, k))[jv], atol=1e-6,
                                   err_msg=k)


def test_two_level_march_matches_under_budget(scene_inputs):
    """The eval budget (flat_frac 0.5): no thinning, the packed buffers match
    slot for slot."""
    j, t = _march_both(scene_inputs, budget=512 * 48 // 2)
    _assert_same_pack(j, t)
    assert 0 < int(t.valid.sum()) < t.valid.numel()


def test_two_level_march_matches_with_both_thinnings(scene_inputs):
    """A small budget overflows both the group budget and the fine budget,
    so both Bresenham thinnings (float32 divisions) select the samples."""
    ro, rd, bf, aabb = scene_inputs
    budget = 768
    budget_g = max(-(-int(round(budget * 2.5)) // (4 * 16)) * 16, 16)
    plan = trm.group_plan(_t(ro), _t(rd), _t(bf), aabb=_t(aabb), **EVAL)
    assert int(plan.keep.sum()) > budget_g          # group thinning runs
    j, t = _march_both(scene_inputs, budget=budget)
    assert int(t.valid.sum()) >= budget - 2          # fine thinning ran, full
    _assert_same_pack(j, t)
