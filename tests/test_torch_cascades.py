"""Port parity at bound 2 (two cascades): cascade selection, the occupancy
update of both cascades, the per-mip coarse tightening, the single-level
march over the cone-stepped ladder, the fast-path render and the
`WideSyntheticScene` of the reference.

The JAX march functions run eagerly here, op by op, as the port does: inside
`jax.jit` XLA:CPU contracts a*b+c into FMAs, which moves a position by an
ulp and can move a sample across a cell boundary. Integer outputs (tightened
intervals from the same coarse cells, valid masks, ray ids) must be exact;
floats within 1e-6. The occupancy update gets the reference's per-cascade
cell jitter (and a partial update's occupied-cell uniforms), rebuilt from
its key splits. Renders hold 1e-4 of the reference's; the analytic scene is
the field, so the comparison checks the march and the compositing, not a
network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_full_rays as j_full_rays
from seal3d_tpu.data.synthetic import WideSyntheticScene as JWide
from seal3d_tpu.ops import raymarch as jrm
from seal3d_tpu.ops.bitfield import GRID_CELLS, GRID_SIZE
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as j_render_rays
from seal3d_tpu_torch.data.rays import get_full_rays as t_full_rays
from seal3d_tpu_torch.data.synthetic import WideSyntheticScene as TWide
from seal3d_tpu_torch.ops import raymarch as trm
from seal3d_tpu_torch.ops.morton import morton3d
from seal3d_tpu_torch.render import occupancy as tocc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.render.renderer import render_rays as t_render_rays


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BOUND, CASCADES = 2.0, 2
MARCH = dict(bound=BOUND, cascades=CASCADES, max_steps=512,
             num_candidates=256, min_near=0.05, occ_stride=4, coarse_steps=64)


def _t(a):
    return torch.from_numpy(np.array(a))


class _JField:
    """The reference's analytic scene as a field (sigma, rgb)."""

    @staticmethod
    def apply(params, cfg, x, d, valid=None):
        return cfg.density(x), cfg.color(x, d)


class _TField(_JField):
    pass


def _full_jitter(key, cascades):
    """The cell jitter the reference's full update draws for each cascade
    (one key split per cascade, then one uniform draw per cell)."""
    out = []
    for _ in range(cascades):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.uniform(sub, (GRID_CELLS, 3))))
    return np.stack(out)


@pytest.fixture(scope="module")
def occ2():
    """Both packages' full update of the wide scene's two cascades with the
    same cell jitter: (reference state, port state)."""
    key = jax.random.PRNGKey(0)
    j = jocc.occupancy_update(jocc.occupancy_init(CASCADES, bound=BOUND),
                              JWide().density, key, bound=BOUND,
                              density_thresh=0.01, full=True)
    t = tocc.occupancy_update(tocc.occupancy_init(CASCADES), TWide().density,
                              bound=BOUND, density_thresh=0.01, full=True,
                              jitter=torch.from_numpy(_full_jitter(key, 2)))
    return j, t


@pytest.fixture(scope="module")
def rays():
    """A 16x16 view of the wide scene, one ray that misses the box and one
    that starts inside it."""
    ds = JWide().make_dataset(n_views=1, h=16, w=16, seed=3)
    r = j_full_rays(jnp.asarray(ds.poses[0]), jnp.asarray(ds.intrinsics),
                    16, 16)
    ro, rd = np.array(r["rays_o"]), np.array(r["rays_d"])
    ro[-2:] = [[6.0, 0, 0], [1.2, 0.1, -0.3]]
    rd[-2:] = [[1.0, 0, 0], [0.0, 0.6, 0.8]]
    return ro, rd


def test_occupancy_at_selects_the_cascade(occ2):
    """A point outside [-1, 1]^3 reads cascade 1, one inside with a small dt
    reads cascade 0, a large dt forces cascade 1: the same bits as the
    reference, on a bitfield with one cell set in one cascade."""
    p_out, p_in = [1.5, 0.2, -0.3], [0.4, -0.1, 0.2]
    x = np.array([p_out, p_in], np.float32)
    for cas, p in ((1, p_out), (0, p_in)):
        cell = np.clip(((np.array(p) / min(2.0**cas, BOUND) * 0.5 + 0.5)
                        * GRID_SIZE).astype(np.int64), 0, GRID_SIZE - 1)
        flat = cas * GRID_CELLS + int(morton3d(torch.from_numpy(cell)))
        bf = np.zeros(2 * GRID_CELLS // 8, np.uint8)
        bf[flat >> 3] |= np.uint8(1 << (flat & 7))
        # a step below cascade 0's cell size, and one above it
        want = {0.0034: [cas == 1, cas == 0], 0.05: [cas == 1, False]}
        for dt, bits in want.items():
            dts = np.full(2, dt, np.float32)
            j = np.asarray(jrm.occupancy_at(jnp.asarray(x), jnp.asarray(dts),
                                            jnp.asarray(bf), CASCADES, BOUND))
            t = trm.occupancy_at(_t(x), _t(dts), _t(bf), CASCADES, BOUND)
            np.testing.assert_array_equal(t.numpy(), j)
            assert t.tolist() == bits, (cas, dt)


def test_full_update_both_cascades(occ2):
    j, t = occ2
    np.testing.assert_allclose(t.density_grid.numpy(),
                               np.asarray(j.density_grid), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(t.bitfield.numpy(), np.asarray(j.bitfield))
    np.testing.assert_array_equal(t.occ_aabb.numpy(), np.asarray(j.occ_aabb))
    per_cascade = np.unpackbits(t.bitfield.numpy()).reshape(2, -1).sum(1)
    assert (per_cascade > 0).all(), per_cascade   # content on both cascades


def test_partial_update_and_mark_untrained(occ2):
    """A partial update (rotating slice plus occupied-cell resamples, per
    cascade) from the full update's state, after mark_untrained at bound 2
    with the wide scene's cameras."""
    from seal3d_tpu.data.provider import rand_poses

    j0, t0 = occ2
    poses = rand_poses(np.random.default_rng(0), 4, radius=4.0,
                       theta_range=(30, 120)).astype(np.float32)
    intr = np.array([26.6, 26.6, 16.0, 16.0], np.float32)
    j0 = jocc.mark_untrained(j0, jnp.asarray(poses), jnp.asarray(intr),
                             bound=BOUND)
    t0 = tocc.mark_untrained(t0, torch.from_numpy(poses),
                             torch.from_numpy(intr), bound=BOUND)
    np.testing.assert_array_equal(t0.density_grid.numpy() < 0,
                                  np.asarray(j0.density_grid) < 0)
    assert (t0.density_grid[1] < 0).any() and (t0.density_grid[0] >= 0).any()
    # the partial update resamples cells by the CDF of `density > 0`, where
    # the full update's densities underflow to 0 (an ulp apart in the two
    # packages) shift every later index: both start from the reference's grid
    t0 = t0._replace(density_grid=torch.from_numpy(np.array(j0.density_grid)))

    key = jax.random.PRNGKey(5)
    j = jocc.occupancy_update(j0, JWide().density, key, bound=BOUND,
                              density_thresh=0.01, full=False)
    occ_cells, n_cells = 2**16, GRID_CELLS // 8 + 2**16
    uniforms, jitter = [], []
    for _ in range(CASCADES):    # the reference's per-cascade key splits
        key, k2, k3 = jax.random.split(key, 3)
        uniforms.append(np.array(jax.random.uniform(k2, (occ_cells,))))
        jitter.append(np.array(jax.random.uniform(k3, (n_cells, 3))))
    t = tocc.occupancy_update(t0, TWide().density, bound=BOUND,
                              density_thresh=0.01, full=False,
                              jitter=torch.from_numpy(np.stack(jitter)),
                              uniforms=torch.from_numpy(np.stack(uniforms)))
    np.testing.assert_allclose(t.density_grid.numpy(),
                               np.asarray(j.density_grid), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(t.bitfield.numpy(), np.asarray(j.bitfield))
    np.testing.assert_array_equal(t.occ_aabb.numpy(), np.asarray(j.occ_aabb))
    assert int(t.iter_density) == int(j.iter_density) == 2


@pytest.mark.parametrize("dt_gamma", [0.0, 1 / 128])
def test_coarse_tighten_two_cascades(occ2, rays, dt_gamma):
    j_occ, _ = occ2
    ro, rd = rays
    bf = np.asarray(j_occ.bitfield)
    aabb = np.array([-2, -2, -2, 2, 2, 2], np.float32)
    jn, jf = jrm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.asarray(aabb), 0.05)
    tn, tf = trm.near_far_from_aabb(_t(ro), _t(rd), _t(aabb), 0.05)
    kw = dict(n_steps=64, dt_gamma=dt_gamma, max_steps=512)
    jn2, jf2 = jrm.coarse_tighten(jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.asarray(bf), jn, jf, CASCADES, BOUND,
                                  **kw)
    tn2, tf2 = trm.coarse_tighten(_t(ro), _t(rd), _t(bf), tn, tf, CASCADES,
                                  BOUND, **kw)
    np.testing.assert_array_equal(tn2.numpy(), np.asarray(jn2))
    np.testing.assert_array_equal(tf2.numpy(), np.asarray(jf2))
    tightened = (tn2 > tn + 1e-4) | (tf2 < tf - 1e-4)
    assert tightened.any() and (tn2 < tf2).any()


@pytest.mark.parametrize("dt_gamma", [0.0, 1 / 128])
def test_march_rays_flat_bound2(occ2, rays, dt_gamma):
    j_occ, _ = occ2
    ro, rd = rays
    bf = np.asarray(j_occ.bitfield)
    jitter = np.random.default_rng(1).uniform(size=ro.shape[0]) \
        .astype(np.float32)
    kw = dict(MARCH, dt_gamma=dt_gamma, k=48, budget=4096)
    j = jrm.march_rays_flat(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(bf),
                            perturb=jnp.asarray(jitter), **kw)
    t = trm.march_rays_flat(_t(ro), _t(rd), _t(bf), perturb=_t(jitter), **kw)
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    np.testing.assert_array_equal(t.ray_id.numpy()[jv], np.asarray(j.ray_id)[jv])
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    for k in ("ts", "deltas", "xyzs"):
        np.testing.assert_allclose(getattr(t, k).numpy()[jv],
                                   np.asarray(getattr(j, k))[jv], atol=1e-6,
                                   err_msg=k)
    outer = t.xyzs[t.valid].abs().amax(-1) > 1.0
    assert outer.any() and (~outer).any()   # samples on both cascades


def test_render_bound2_fast_path(occ2):
    """The flat branch at bound 2 with the cone ladder, the analytic scene as
    the field: image and depth within 1e-4 of the reference's."""
    j_occ, _ = occ2
    ds = JWide().make_dataset(n_views=1, h=16, w=16, seed=4)
    r = j_full_rays(jnp.asarray(ds.poses[0]), jnp.asarray(ds.intrinsics),
                    16, 16)
    kw = dict(bound=BOUND, dt_gamma=1 / 128, max_steps=512, budget_per_ray=96,
              num_candidates=384, min_near=0.05, coarse_steps=64,
              flat_frac=0.5)
    jopts, topts = JOpts(**kw), TOpts(**kw)
    assert jopts.cascades == topts.cascades == 2
    jout = j_render_rays(None, _JField, JWide(), j_occ.bitfield,
                         r["rays_o"], r["rays_d"], jopts, bg_color=1.0)
    tout = t_render_rays(None, _TField, TWide(), _t(j_occ.bitfield),
                         _t(r["rays_o"]), _t(r["rays_d"]), topts, bg_color=1.0)
    np.testing.assert_allclose(tout["image"].numpy(),
                               np.asarray(jout["image"]), atol=1e-4)
    np.testing.assert_allclose(tout["depth"].numpy(),
                               np.asarray(jout["depth"]), atol=1e-4)
    assert int(tout["num_samples"]) == int(jout["num_samples"]) > 0
    gt = np.asarray(ds.images[0], np.float32).reshape(-1, 3) / 255.0
    psnr = -10 * np.log10(np.mean((tout["image"].numpy() - gt) ** 2))
    assert psnr > 26.0, psnr


def test_wide_scene_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    x[:64] = [1.45, 0.1, 0.2] + rng.normal(0, 0.1, (64, 3))   # a satellite
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(TWide().density(_t(x)).numpy(),
                               np.asarray(JWide().density(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TWide().color(_t(x), _t(d)).numpy(),
        np.asarray(JWide().color(jnp.asarray(x), jnp.asarray(d))), atol=1e-5)
    jds = JWide().make_dataset(n_views=2, h=16, w=16, seed=3)
    tds = TWide().make_dataset(n_views=2, h=16, w=16, seed=3)
    np.testing.assert_allclose(tds.poses, jds.poses, atol=1e-6)
    np.testing.assert_allclose(tds.intrinsics, jds.intrinsics, atol=1e-6)
    assert tds.radius == jds.radius == 4.0
    jimg, jdep = JWide().render_view(jds.poses[1], jds.intrinsics, 16, 16)
    timg, tdep = TWide().render_view(tds.poses[1], tds.intrinsics, 16, 16)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-5)
    np.testing.assert_allclose(tdep.numpy(), np.asarray(jdep), atol=1e-4)
    assert float(timg.std()) > 0.05   # the view holds the scene
