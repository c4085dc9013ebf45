"""Port parity over many train steps: both packages train the same tiny
field on the same `SyntheticScene` from the same initial parameters, with
every random number of the run (training view, pixels, march jitter, the
jittered cell positions of each grid update) drawn once from the reference's
key splits and handed to the port as inputs.

Size: 4 levels at T=2^15 (the `hash` gridtype then has one dense level, 17^3,
and three hashed ones, so the native and the padded layouts differ), 256
rays, budget 48, 24x24 views (8 train, 2 val), 128 steps with a grid update
every 16: two full ones, then partial ones (a rotating slice plus resampled
occupied cells). The reference runs its jitted step on its fp32 encodes: the
`xla` backend for `bucket` (the same native layout), and for `halo` and
`pallas` its Pallas kernel K1 / K3 replaced by the plain take-gather over
`corner_indices_weights` (as tests/test_ops.py holds K1). The port runs
`halo`, `bucket` and `pallas` through its kernels' plain versions on the CPU.

Tolerances, per backend:
- val PSNR of the EMA params, each package through its own `evaluate`:
  within 0.3 dB;
- the loss curve: the mean loss of each 16-step block within 10% of the
  reference's. A single step may differ more: the MLPs round to bf16 on both
  sides, and the first grid update thresholds an untrained field's density,
  bf16 values within a few ulps of their mean, so the first bitfields differ
  in cells that rounding decides (measured: up to 2% on the first step).
The gap between `halo` and the `hash` backends is recorded per package
(printed, and held to be the same in both within 0.5 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_rays as j_get_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
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
from test_torch_train_step import (NUM_RAYS, OPTS, _k1_take_oracle,
                                   _k3_take_oracle)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the train point (OPTS, NUM_RAYS) and the reference's fp32 encodes in place
# of its Pallas kernels are test_torch_train_step.py's
STEPS, BLOCK, FULL_UPDATES = 128, 16, 2
PARTIAL_CELLS, OCC_CELLS = GRID_CELLS // 8, 2**16   # occupancy_update's
PSNR_TOL_DB = 0.3
BLOCK_LOSS_RTOL = 0.10
GAP_TOL_DB = 0.5
# port backend -> (the reference's fp32 backend, gridtype)
BACKENDS = {"halo": ("halo", "wrap"), "bucket": ("xla", "hash"),
            "pallas": ("pallas", "hash")}
# backend -> what `_train_both` returned: each case trains once a process
RESULTS = {}


@pytest.fixture(scope="module")
def scene():
    train = JScene().make_dataset(n_views=8, h=24, w=24, seed=0)
    val = JScene().make_dataset(n_views=2, h=24, w=24, seed=1)
    return train, val


def _to_port(ds):
    return NeRFDataset(poses=ds.poses, images=ds.images,
                       intrinsics=ds.intrinsics, h=ds.h, w=ds.w)


def _result(scene, backend):
    if backend not in RESULTS:
        with pytest.MonkeyPatch.context() as mp:
            RESULTS[backend] = _train_both(scene, backend, mp)
    return RESULTS[backend]


def _train_both(scene, backend, monkeypatch):
    """Train the reference and the port side by side -> (reference losses,
    port losses, reference val PSNR, port val PSNR)."""
    train, val = scene
    jbackend, gridtype = BACKENDS[backend]
    if jbackend == "halo":
        _k1_take_oracle(monkeypatch)
    if jbackend == "pallas":
        _k3_take_oracle(monkeypatch)
    kw = dict(bound=1.0, log2_hashmap_size=15, num_levels=4, gridtype=gridtype)
    cfg = dict(num_rays=NUM_RAYS, max_steps=STEPS)
    jtr = JTrainer(jngp, jngp.NGPConfig(grid_backend=jbackend, **kw),
                   JOpts(**OPTS), JCfg(**cfg), dataset=train,
                   key=jax.random.PRNGKey(0))
    jtr.init_state()
    ttr = TTrainer(tngp, tngp.NGPConfig(grid_backend=backend, **kw),
                   TOpts(**OPTS), TCfg(**cfg), dataset=_to_port(train),
                   device="cpu")
    assert ttr.fcfg.grid.level_params == tuple(
        tuple(p) for p in jtr.fcfg.grid.level_params)
    ttr.init_state()
    params = params_from_jax(jax.tree.map(np.asarray, jtr.state.params))
    ttr.state = ttr.state._replace(
        params=params, ema_params=jax.tree.map(torch.clone, params),
        opt_state=ttr.optimizer.init(params))
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
            # the reference's occupancy_update draws, for its one cascade,
            # the cells' jitter (and a partial update's resampling uniforms)
            # from these splits of its key
            full = i // BLOCK < FULL_UPDATES
            if full:
                jtr.state = jtr._update_grid_full(jtr.state, kgrid)
                _, kcell = jax.random.split(kgrid)
                uniforms, n_cells = None, GRID_CELLS
            else:
                jtr.state = jtr._update_grid_partial(jtr.state, kgrid)
                _, kocc, kcell = jax.random.split(kgrid, 3)
                uniforms = torch.from_numpy(np.array(
                    jax.random.uniform(kocc, (OCC_CELLS,)))[None])
                n_cells = PARTIAL_CELLS + OCC_CELLS
            jitter = np.array(jax.random.uniform(kcell, (n_cells, 3)))[None]
            with torch.no_grad():
                occ = tocc.occupancy_update(
                    ttr.state.occ, density_fn, 1.0,
                    density_thresh=ttr.cfg.density_thresh, full=full,
                    jitter=torch.from_numpy(jitter), uniforms=uniforms)
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
    jpsnr = jtr.evaluate(val)
    tpsnr = ttr.evaluate(_to_port(val))
    return np.array(jlosses), np.array(tlosses), jpsnr, tpsnr


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_training_matches_jax(scene, backend):
    jl, tl, jpsnr, tpsnr = _result(scene, backend)
    jb = jl.reshape(-1, BLOCK).mean(1)
    tb = tl.reshape(-1, BLOCK).mean(1)
    print(f"\n[parity {backend}] val PSNR reference {jpsnr:.3f} dB, port "
          f"{tpsnr:.3f} dB; block losses reference {np.round(jb, 5)}, port "
          f"{np.round(tb, 5)}; largest single-step relative difference "
          f"{np.abs(tl / jl - 1).max():.3e}")
    # the run trained: the loss fell clearly in both packages
    assert jb[-1] < 0.5 * jb[0] and tb[-1] < 0.5 * tb[0], (jb, tb)
    np.testing.assert_allclose(tb, jb, rtol=BLOCK_LOSS_RTOL)
    assert abs(tpsnr - jpsnr) <= PSNR_TOL_DB, (jpsnr, tpsnr)


def test_hash_backends_gap_is_the_same_in_both_packages(scene):
    """`halo` against the two `hash` backends, per package: whatever gap the
    reference shows at this size, the port shows the same."""
    psnr = {b: _result(scene, b)[2:] for b in BACKENDS}
    for hashed in ("bucket", "pallas"):
        jgap = psnr["halo"][0] - psnr[hashed][0]
        tgap = psnr["halo"][1] - psnr[hashed][1]
        print(f"\n[parity gap] halo - {hashed}: reference {jgap:+.3f} dB, "
              f"port {tgap:+.3f} dB")
        assert abs(jgap - tgap) <= GAP_TOL_DB, (hashed, jgap, tgap)
