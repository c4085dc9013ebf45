"""Error-map ray sampling in the port against the JAX package.

- The samplers: `error_map_inds` on the cells and in-cell uniforms the
  reference's `get_rays` draws from its key (`jax.random.categorical`, then
  `jax.random.uniform`) gives the same flat pixel indices, at image sizes
  that are and are not multiples of the 128x128 map; `patch_inds` on the
  reference's patch corners the same patches; the port's own draws
  (`torch.multinomial`) land only on cells with weight.
- The state: both trainers start from the same params and occupancy (the
  test_torch_train_step.py scene) with error_map=True and take 4 steps on
  the same pixels (drawn from the reference's map row) and jitter, the
  reference eagerly (see test_torch_train_step.py for why); after each step
  the maps agree within 1e-6 (the mirror of tests/test_checkpoint.py:177)
  and the refreshed cells match a float64 numpy replay of the EMA in which
  the last ray to draw a cell sets it.
- `.npz`: the map survives save and load within the port and in both
  directions between the packages, also in the light checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu_torch.data.rays import (error_map_cells, error_map_inds,
                                        get_rays, patch_inds)
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.trainer import StepRandom
from test_torch_train_step import NUM_RAYS, _trainers, scene  # noqa: F401

MAP_TOL = 1e-6
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pose_intr(h, w, seed=3):
    from seal3d_tpu.data.provider import rand_poses

    pose = rand_poses(np.random.default_rng(seed), 1, radius=2.2)[0]
    fx = 0.5 * w / np.tan(np.deg2rad(25.0))
    return pose.astype(np.float32), np.array([fx, fx, w / 2, h / 2],
                                             np.float32)


@pytest.mark.parametrize("h,w", [(128, 128), (75, 100), (300, 200)])
def test_error_map_sampler_matches_jax(h, w):
    rng = np.random.default_rng(h)
    emap = rng.uniform(0.0, 1.0, 128 * 128).astype(np.float32)
    emap[rng.random(emap.shape) < 0.7] = 0.0     # most cells never drawn
    pose, intr = _pose_intr(h, w)
    n = 4096
    key = jax.random.PRNGKey(h * w)
    ref = j_get_rays(key, jnp.asarray(pose), jnp.asarray(intr), h, w, n,
                     error_map=jnp.asarray(emap))
    # the reference's draws, from the same key splits
    k1, k2 = jax.random.split(key)
    cells = jax.random.categorical(k1, jnp.log(jnp.asarray(emap) + 1e-8),
                                   shape=(n,))
    u = jax.random.uniform(k2, (n, 2))
    inds = error_map_inds(torch.from_numpy(emap), h, w, n,
                          cells=torch.from_numpy(np.array(cells)).long(),
                          u=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(ref["inds"]))
    rays = get_rays(torch.from_numpy(pose), torch.from_numpy(intr), h, w, n,
                    inds=inds)
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(rays[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)
    # where the map's cells tile the image exactly, a pixel's refresh cell
    # is the cell it was drawn from (elsewhere the reference maps it back
    # by integer division, as the port does)
    if h % 128 == 0 and w % 128 == 0:
        np.testing.assert_array_equal(error_map_cells(inds, h, w).numpy(),
                                      np.array(cells))


def test_patch_sampler_matches_jax():
    h, w, p, n = 40, 56, 4, 256
    pose, intr = _pose_intr(h, w)
    key = jax.random.PRNGKey(5)
    ref = j_get_rays(key, jnp.asarray(pose), jnp.asarray(intr), h, w, n,
                     patch_size=p)
    k1, _ = jax.random.split(key)
    corners = np.stack([
        np.array(jax.random.randint(k1, (n // p**2,), 0, h - p)),
        np.array(jax.random.randint(jax.random.fold_in(k1, 1), (n // p**2,),
                                    0, w - p))], -1)
    inds = patch_inds(h, w, n, p, corners=torch.from_numpy(corners))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(ref["inds"]))
    # drawn corners keep every patch inside the image
    drawn = patch_inds(h, w, n, p,
                       generator=torch.Generator().manual_seed(0)).numpy()
    assert drawn.shape == (n,) and drawn.min() >= 0 and drawn.max() < h * w
    rows, cols = drawn.reshape(-1, p, p) // w, drawn.reshape(-1, p, p) % w
    assert (np.diff(rows, axis=1) == 1).all() and (np.diff(cols, axis=2)
                                                   == 1).all()


def test_port_draw_follows_the_map():
    emap = torch.zeros(128 * 128)
    hot = torch.tensor([5, 777, 9000, 16383])
    emap[hot] = torch.tensor([1.0, 2.0, 3.0, 4.0])
    inds = error_map_inds(emap, 256, 256, 20000,
                          generator=torch.Generator().manual_seed(1))
    cells = error_map_cells(inds, 256, 256)
    counts = torch.stack([(cells == c).sum() for c in hot]).float()
    assert int(counts.sum()) == 20000
    np.testing.assert_allclose((counts / counts.sum()).numpy(),
                               [0.1, 0.2, 0.3, 0.4], atol=0.02)


def _replay(emap, img_idx, cells, per_ray):
    """The reference's refresh in float64 numpy: rays in order, the last
    to draw a cell sets it from the cell's value before the step."""
    cur = emap[img_idx].astype(np.float64)
    new = cur.copy()
    for c, e in zip(cells, per_ray):
        new[c] = cur[c] * 0.9 + 0.1 * e
    out = emap.astype(np.float64).copy()
    out[img_idx] = new
    return out


def test_error_map_steps_match_jax(scene):  # noqa: F811
    import dataclasses

    jtr, ttr = _trainers(scene, "xla", "hash", 0.5)
    ds = scene[0]
    # what init_state makes with error_map=True
    jtr.state = jtr.state._replace(
        error_map=jnp.full((len(ds), 128 * 128), 0.1, jnp.float32))
    ttr.state = ttr.state._replace(
        error_map=torch.full((len(ds), 128 * 128), 0.1))
    key = jax.random.PRNGKey(11)
    for _ in range(STEPS):
        key, kstep = jax.random.split(key)
        kimg, kray, _, kjit = jax.random.split(kstep, 4)
        img_idx = int(jax.random.randint(kimg, (), 0, len(ds)))
        before = ttr.state.error_map.numpy().copy()
        rays = j_get_rays(kray, jnp.asarray(ds.poses)[img_idx],
                          jnp.asarray(ds.intrinsics), ds.h, ds.w, NUM_RAYS,
                          error_map=jtr.state.error_map[img_idx])
        rand = StepRandom(
            img_idx=torch.tensor(img_idx),
            inds=torch.from_numpy(np.array(rays["inds"])).long(), bg=None,
            jitter=torch.from_numpy(np.array(
                jax.random.uniform(kjit, (NUM_RAYS,)))))
        with jax.disable_jit():
            jtr.state, jm = jtr._train_step(jtr.state, kstep)
        tm = ttr.train_step(rand)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        got = ttr.state.error_map.numpy()
        want = np.asarray(jtr.state.error_map)
        assert np.abs(got - want).max() <= MAP_TOL, np.abs(got - want).max()
        # the port's refresh is the replay of its own per-ray errors
        cells = error_map_cells(rand.inds, ds.h, ds.w).numpy()
        changed = np.flatnonzero(got[img_idx] != before[img_idx])
        assert set(changed) <= set(cells) and len(changed) > 0
        batch = ttr.sample_batch(rand)
        assert batch["gt"].shape == (NUM_RAYS, 3)
    assert int(ttr.state.step) == STEPS


def test_refresh_keeps_the_last_ray_of_a_cell():
    from seal3d_tpu_torch.train.trainer import refresh_error_map

    rng = np.random.default_rng(4)
    emap = rng.uniform(0, 1, (3, 64)).astype(np.float32)
    cells = rng.integers(0, 20, 500)          # many rays a cell
    per_ray = rng.uniform(0, 1, 500).astype(np.float32)
    got = refresh_error_map(torch.from_numpy(emap), torch.tensor(1),
                            torch.from_numpy(cells),
                            torch.from_numpy(per_ray)).numpy()
    np.testing.assert_allclose(got, _replay(emap, 1, cells, per_ray),
                               atol=1e-7)
    # the reference's scatter on the CPU agrees
    cur = jnp.asarray(emap[1])
    jc = jnp.asarray(cells)
    want = cur.at[jc].set(cur[jc] * 0.9 + 0.1 * jnp.asarray(per_ray))
    np.testing.assert_array_equal(got[1], np.asarray(want))


def test_error_map_npz_both_ways(scene, tmp_path):  # noqa: F811
    import dataclasses

    jtr, ttr = _trainers(scene, "xla", "hash", 0.5)
    for tr in (jtr, ttr):      # init_state allocates the map
        tr.cfg = dataclasses.replace(tr.cfg, error_map=True)
        tr.init_state()
        assert tuple(tr.state.error_map.shape) == (2, 128 * 128)
    emap = np.random.default_rng(9).uniform(0, 1, (2, 128 * 128)).astype(
        np.float32)
    ttr.state = ttr.state._replace(error_map=torch.from_numpy(emap))
    for full in (True, False):
        path = str(tmp_path / f"port_{full}.npz")
        ttr.save_checkpoint(path, full=full)
        with np.load(path) as data:
            np.testing.assert_array_equal(data["error_map"], emap)
        fresh = tckpt.load_state(path, ttr.state._replace(
            error_map=torch.zeros(2, 128 * 128)))
        np.testing.assert_array_equal(fresh.error_map.numpy(), emap)
        jstate = jckpt.load_state(path, jtr.state)
        np.testing.assert_array_equal(np.asarray(jstate.error_map), emap)
    # JAX -> port
    jtr.state = jtr.state._replace(error_map=jnp.asarray(emap[::-1].copy()))
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jtr.state)
    ttr.load_checkpoint(path)
    np.testing.assert_array_equal(ttr.state.error_map.numpy(), emap[::-1])
