"""Port parity over many train steps at bound 2, the CLI's default: both
packages train the same tiny field on the reference's `WideSyntheticScene`
(content on both cascades) from the same initial parameters, with every
random number of the run (training view, pixels, march jitter, the jittered
cells of each grid update in both cascades, a partial update's resampling
uniforms) drawn once from the reference's key splits and handed to the port.

Size: the `halo` backend (the -O default) at 4 levels, T=2^15, 256 rays,
24x24 views (8 train, 2 val), 64 steps with a grid update every 16 (one
full, then partial ones), at bench.py's bound-2 recipe: dt_gamma 1/128 (the
cone-stepped single-level march; the two-level one is single-cascade),
max_steps 512, 256 candidates, coarse 64, budget 48, lr 3e-3 (lr 1e-2
collapses the field at bound 2). The reference runs its jitted step with
its Pallas kernel K1 replaced by the plain fp32 take-gather (as
tests/test_torch_train_parity.py does); the port runs K1's plain version.

Tolerances, as tests/test_torch_train_parity.py holds them: val PSNR of the
EMA params within 0.3 dB, each through its own `evaluate`; the mean loss of
each 16-step block within 10% of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import WideSyntheticScene as JWide
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops.bitfield import GRID_CELLS
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render import occupancy as tocc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train.checkpoint import params_from_jax
from seal3d_tpu_torch.train.trainer import StepRandom
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from seal3d_tpu_torch.train.trainer import Trainer as TTrainer
from test_torch_train_step import _k1_take_oracle


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
OPTS = dict(bound=BOUND, dt_gamma=1 / 128, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05)
NUM_RAYS, STEPS, BLOCK, FULL_UPDATES = 256, 64, 16, 1
PARTIAL_CELLS, OCC_CELLS = GRID_CELLS // 8, 2**16   # occupancy_update's
PSNR_TOL_DB = 0.3
BLOCK_LOSS_RTOL = 0.10


def _grid_randoms(key, full):
    """The cell jitter [C, Q, 3] (and, for a partial update, the occupied
    cells' uniforms [C, OCC_CELLS]) the reference's occupancy_update draws
    from `key`, cascade by cascade."""
    jitter, uniforms = [], []
    for _ in range(CASCADES):
        if full:
            key, kcell = jax.random.split(key)
            n_cells = GRID_CELLS
        else:
            key, kocc, kcell = jax.random.split(key, 3)
            uniforms.append(np.array(jax.random.uniform(kocc, (OCC_CELLS,))))
            n_cells = PARTIAL_CELLS + OCC_CELLS
        jitter.append(np.array(jax.random.uniform(kcell, (n_cells, 3))))
    return (torch.from_numpy(np.stack(jitter)),
            torch.from_numpy(np.stack(uniforms)) if uniforms else None)


def test_bound2_training_matches_jax(monkeypatch):
    _k1_take_oracle(monkeypatch)
    train = JWide().make_dataset(n_views=8, h=24, w=24, seed=0)
    val = JWide().make_dataset(n_views=2, h=24, w=24, seed=1)
    to_port = lambda ds: NeRFDataset(poses=ds.poses, images=ds.images,
                                     intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    kw = dict(bound=BOUND, log2_hashmap_size=15, num_levels=4,
              grid_backend="halo", gridtype="wrap")
    # eval: one 1024-ray chunk a view (the [N, K] eval branch queries every
    # slot of a chunk, pads too, so the default 8192 would cost 8x)
    cfg = dict(lr=3e-3, num_rays=NUM_RAYS, max_steps=STEPS, eval_chunk=1024)
    jtr = JTrainer(jngp, jngp.NGPConfig(**kw), JOpts(**OPTS), JCfg(**cfg),
                   dataset=train, key=jax.random.PRNGKey(0))
    jtr.init_state()
    ttr = TTrainer(tngp, tngp.NGPConfig(**kw), TOpts(**OPTS), TCfg(**cfg),
                   dataset=to_port(train), device="cpu")
    assert ttr.opts.cascades == jtr.opts.cascades == CASCADES
    ttr.init_state()
    params = params_from_jax(jax.tree.map(np.asarray, jtr.state.params))
    ttr.state = ttr.state._replace(
        params=params, ema_params=jax.tree.map(torch.clone, params),
        opt_state=ttr.optimizer.init(params))
    # mark_untrained at bound 2 marked the same cells of both cascades
    np.testing.assert_array_equal(ttr.state.occ.density_grid.numpy(),
                                  np.asarray(jtr.state.occ.density_grid))

    def density_fn(x):
        return ttr.field.density(ttr.state.params, ttr.fcfg,
                                 x)["sigma"] * ttr.opts.density_scale

    key = jax.random.PRNGKey(7)
    jlosses, tlosses = [], []
    for i in range(STEPS):
        key, kgrid, kstep = jax.random.split(key, 3)
        if i % BLOCK == 0:
            full = i // BLOCK < FULL_UPDATES
            update = jtr._update_grid_full if full else jtr._update_grid_partial
            jtr.state = update(jtr.state, kgrid)
            jitter, uniforms = _grid_randoms(kgrid, full)
            with torch.no_grad():
                occ = tocc.occupancy_update(
                    ttr.state.occ, density_fn, BOUND,
                    density_thresh=ttr.cfg.density_thresh, full=full,
                    jitter=jitter, uniforms=uniforms)
            ttr.state = ttr.state._replace(occ=occ)
        # the reference's sample_batch draws from these four keys
        kimg, kray, _, kjit = jax.random.split(kstep, 4)
        img_idx = jax.random.randint(kimg, (), 0, len(train))
        rays = j_get_rays(kray, jnp.asarray(train.poses)[img_idx],
                          jnp.asarray(train.intrinsics), train.h, train.w,
                          NUM_RAYS)
        rand = StepRandom(
            img_idx=torch.tensor(int(img_idx)),
            inds=torch.from_numpy(np.array(rays["inds"])).long(), bg=None,
            jitter=torch.from_numpy(np.array(
                jax.random.uniform(kjit, (NUM_RAYS,)))))
        jtr.state, jm = jtr._train_step(jtr.state, kstep)
        tm = ttr.train_step(rand)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
    occupied = np.unpackbits(ttr.state.occ.bitfield.numpy()).reshape(
        CASCADES, -1).sum(1)
    jpsnr = jtr.evaluate(val)
    tpsnr = ttr.evaluate(to_port(val))
    jb = np.array(jlosses).reshape(-1, BLOCK).mean(1)
    tb = np.array(tlosses).reshape(-1, BLOCK).mean(1)
    print(f"\n[parity bound 2] val PSNR reference {jpsnr:.3f} dB, port "
          f"{tpsnr:.3f} dB; block losses reference {np.round(jb, 5)}, port "
          f"{np.round(tb, 5)}; occupied cells by cascade {occupied}")
    assert (occupied > 0).all(), occupied      # both cascades carry content
    assert jb[-1] < 0.7 * jb[0] and tb[-1] < 0.7 * tb[0], (jb, tb)
    np.testing.assert_allclose(tb, jb, rtol=BLOCK_LOSS_RTOL)
    assert abs(tpsnr - jpsnr) <= PSNR_TOL_DB, (jpsnr, tpsnr)
