"""Port parity of the single-level train march, with the jittered start, at
the -O train point scaled to a small batch: N=256 rays, C=256 candidates,
max_steps 512, coarse 64, occ_stride 4, k=48, over an occupancy bitfield of
the analytic scene.

The JAX functions run eagerly, op by op, as the port does (inside `jax.jit`
XLA:CPU contracts a*b+c into FMAs, which moves a jittered start or a sample
position by an ulp and can move a sample across a cell or a Bresenham
boundary). Integer outputs (valid masks, packed slots, offsets, counts, ray
ids) must be exact; floats within 1e-6 on valid slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops import raymarch as jrm
from seal3d_tpu_torch.ops import raymarch as trm

TRAIN = dict(bound=1.0, cascades=1, dt_gamma=0.0, max_steps=512,
             num_candidates=256, min_near=0.05, occ_stride=4, coarse_steps=64)
K = 48


@pytest.fixture(scope="module")
def inputs():
    import jax

    from seal3d_tpu.data.provider import rand_poses
    from seal3d_tpu.data.rays import get_full_rays
    from seal3d_tpu.data.synthetic import SyntheticScene
    from seal3d_tpu.render.occupancy import occupancy_init, occupancy_update

    occ = occupancy_update(occupancy_init(cascades=1), SyntheticScene().density,
                           jax.random.PRNGKey(2), bound=1.0,
                           density_thresh=0.01, full=True)
    pose = rand_poses(np.random.default_rng(7), 1, radius=2.2,
                      theta_range=(30, 120))[0]
    intr = np.array([18.0, 18.0, 8.0, 8.0], np.float32)
    rays = get_full_rays(jnp.asarray(pose), jnp.asarray(intr), 16, 16)
    ro, rd = np.array(rays["rays_o"]), np.array(rays["rays_d"])
    ro[-2:] = [[3.0, 0, 0], [0.1, 0.0, 0.05]]   # a miss and a ray from inside
    rd[-2:] = [[1.0, 0, 0], [0.0, 0.6, 0.8]]
    jitter = np.random.default_rng(1).uniform(size=256).astype(np.float32)
    aabb = np.array([-0.9, -0.8, -0.9, 0.9, 0.7, 0.9], np.float32)
    return ro, rd, np.asarray(occ.bitfield), jitter, aabb


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("dt_gamma", [0.0, 1 / 128])
def test_candidate_ts_with_jitter(inputs, dt_gamma):
    """Both ladders (uniform, and the cone-stepped scan) from jittered
    starts: valid exact, ts and dts within 1e-6."""
    *_, jitter, _ = inputs
    rng = np.random.default_rng(3)
    nears = rng.uniform(0.05, 1.5, 256).astype(np.float32)
    fars = (nears + rng.uniform(0.0, 2.0, 256)).astype(np.float32)
    kw = dict(num_steps=64, dt_gamma=dt_gamma, bound=1.0, max_steps=512)
    jts, jdts, jv = jrm.candidate_ts(_j(nears), _j(fars), perturb=_j(jitter),
                                     **kw)
    tts, tdts, tv = trm.candidate_ts(_t(nears), _t(fars), perturb=_t(jitter),
                                     **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tts.numpy(), np.asarray(jts), rtol=1e-6)
    np.testing.assert_allclose(tdts.numpy(), np.asarray(jdts), rtol=1e-6)
    assert 0 < int(tv.sum()) < tv.numel()


def test_march_candidates_exact(inputs):
    ro, rd, bf, jitter, aabb = inputs
    j = jrm.march_candidates(_j(ro), _j(rd), _j(bf), perturb=_j(jitter),
                             aabb=_j(aabb), **TRAIN)
    t = trm.march_candidates(_t(ro), _t(rd), _t(bf), perturb=_t(jitter),
                             aabb=_t(aabb), **TRAIN)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-6)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-6)
    counts = t[2].sum(1)
    assert int(counts.max()) > K and int((counts > 0).sum()) > 50


def test_march_rays_grid_exact(inputs):
    """The [N, K] train layout: compact_topk's kept-first, ascending-t
    selection (rays over K subsampled by stride) slot for slot."""
    ro, rd, bf, jitter, aabb = inputs
    j = jrm.march_rays_grid(_j(ro), _j(rd), _j(bf), k=K, perturb=_j(jitter),
                            aabb=_j(aabb), **TRAIN)
    t = trm.march_rays_grid(_t(ro), _t(rd), _t(bf), k=K, perturb=_t(jitter),
                            aabb=_t(aabb), **TRAIN)
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    for name in ("xyzs", "dirs", "deltas", "ts"):
        np.testing.assert_allclose(getattr(t, name).numpy()[jv],
                                   np.asarray(getattr(j, name))[jv],
                                   atol=1e-6, err_msg=name)
    assert t.valid.shape == (256, K) and int(t.valid.sum()) > 0


def _assert_same_pack(j, t):
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.ray_id.numpy()[jv], np.asarray(j.ray_id)[jv])
    for name in ("xyzs", "dirs", "deltas", "ts"):
        np.testing.assert_allclose(getattr(t, name).numpy()[jv],
                                   np.asarray(getattr(j, name))[jv],
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("budget", [256 * K // 2, 1024])
def test_march_rays_flat_exact(inputs, budget):
    """The packed train layout under budget (flat_frac 0.5: no thinning) and
    in overflow (1024 slots for several thousand kept samples: the global
    Bresenham thinning and each ray's delta rescale select the samples)."""
    ro, rd, bf, jitter, aabb = inputs
    kw = dict(TRAIN, k=K, budget=budget)
    j = jrm.march_rays_flat(_j(ro), _j(rd), _j(bf), perturb=_j(jitter),
                            aabb=_j(aabb), **kw)
    t = trm.march_rays_flat(_t(ro), _t(rd), _t(bf), perturb=_t(jitter),
                            aabb=_t(aabb), **kw)
    _assert_same_pack(j, t)
    n_valid = int(t.valid.sum())
    if budget == 1024:
        assert n_valid >= budget - 2          # thinned, and full
        assert float(t.deltas[t.valid].max()) > 2 * 2 * 3**0.5 / 512
    else:
        assert 0 < n_valid < budget


def test_compact_flat_direct_matches_grid_under_budget(inputs):
    """Under budget, the one-sort pack holds exactly the [N, K] layout's
    valid samples, ray by ray in ascending t (the packed path only moves
    where they sit)."""
    ro, rd, bf, jitter, aabb = inputs
    ts, dts, valid = trm.march_candidates(_t(ro), _t(rd), _t(bf),
                                          perturb=_t(jitter), aabb=_t(aabb),
                                          **TRAIN)
    g = trm.compact_topk(ts, dts, valid, _t(ro), _t(rd), K)
    f = trm.compact_flat_direct(ts, dts, valid, _t(ro), _t(rd), K, 256 * K)
    np.testing.assert_array_equal(f.ts[f.valid].numpy(), g.ts[g.valid].numpy())
    np.testing.assert_array_equal(f.deltas[f.valid].numpy(),
                                  g.deltas[g.valid].numpy())
    np.testing.assert_array_equal(f.counts.numpy(), g.valid.sum(1).numpy())
