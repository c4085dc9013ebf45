"""Port parity of the occupancy grid: the full update and mark_untrained.

The full update jitters each queried cell with random numbers; the test
rebuilds the reference's jitter from its key (the per-cascade split of
occupancy_update and the uniform draw of cell_world_positions) and hands the
same numbers to the port. The density is each package's analytic
SyntheticScene, so the comparison checks the grid logic, not a field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.provider import rand_poses
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.ops.bitfield import GRID_CELLS
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu_torch.data.synthetic import SyntheticScene as TScene
from seal3d_tpu_torch.render import occupancy as tocc


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prior_grid(seed=0):
    """A trained-looking prior: positive densities plus untrained (-1) cells."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 0.02, size=(1, GRID_CELLS)).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.1] = -1.0
    return g


def test_full_update_matches_jax_with_same_jitter():
    """Bitfield equal but for <= 1e-4 of cells (a density within rounding of
    the threshold may land on either side); mean_density rtol 1e-5;
    occ_aabb 1e-6; every trained cell's new density rtol 1e-4."""
    prior = _prior_grid()
    key = jax.random.PRNGKey(7)
    jstate = jocc.occupancy_init(1)._replace(density_grid=jnp.asarray(prior))
    jout = jocc.occupancy_update(jstate, JScene().density, key, bound=1.0,
                                 density_thresh=10.0, full=True)
    _, sub = jax.random.split(key)
    jitter = np.array(jax.random.uniform(sub, (GRID_CELLS, 3)))[None]

    tstate = tocc.occupancy_init(1)._replace(
        density_grid=torch.from_numpy(prior))
    tout = tocc.occupancy_update(tstate, TScene().density, bound=1.0,
                                 density_thresh=10.0,
                                 jitter=torch.from_numpy(jitter))
    jb, tb = np.asarray(jout.bitfield), tout.bitfield.numpy()
    n_diff = int(np.unpackbits(jb ^ tb).sum())
    assert n_diff <= 1e-4 * GRID_CELLS, n_diff
    assert 0 < int(np.unpackbits(tb).sum()) < GRID_CELLS // 2
    np.testing.assert_allclose(float(tout.mean_density),
                               float(jout.mean_density), rtol=1e-5)
    np.testing.assert_allclose(tout.occ_aabb.numpy(), np.asarray(jout.occ_aabb),
                               atol=1e-6)
    np.testing.assert_allclose(tout.density_grid.numpy(),
                               np.asarray(jout.density_grid), rtol=1e-4,
                               atol=1e-6)
    assert int(tout.iter_density) == int(jout.iter_density) == 1


def test_full_update_draws_jitter_from_generator():
    """Without injected jitter the port draws it from its torch.Generator:
    same seed, same grid; the untrained cells stay -1."""
    prior = torch.from_numpy(_prior_grid(1))
    st = tocc.occupancy_init(1)._replace(density_grid=prior)
    a, b = (tocc.occupancy_update(st, TScene().density, bound=1.0,
                                  generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    np.testing.assert_array_equal(a.density_grid.numpy(),
                                  b.density_grid.numpy())
    assert (a.density_grid[prior < 0] == -1.0).all()


def test_mark_untrained_exact():
    """Frustum visibility of every cell center from synthetic-split cameras:
    the same cells are marked untrained."""
    poses = rand_poses(np.random.default_rng(0), 4, radius=2.2,
                       theta_range=(30, 120)).astype(np.float32)
    intr = np.array([34.3, 34.3, 16.0, 16.0], np.float32)
    j = jocc.mark_untrained(jocc.occupancy_init(1), jnp.asarray(poses),
                            jnp.asarray(intr), bound=1.0)
    t = tocc.mark_untrained(tocc.occupancy_init(1), torch.from_numpy(poses),
                            torch.from_numpy(intr), bound=1.0)
    jg, tg = np.asarray(j.density_grid), t.density_grid.numpy()
    np.testing.assert_array_equal(tg, jg)
    assert 0 < int((tg < 0).sum()) < GRID_CELLS
