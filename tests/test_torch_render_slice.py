"""The whole render slice: JAX Trainer.render_image vs the port's, at the -O
eval point scaled down (4 levels at T=2^12, 256-ray chunks, 24x24 views).

Both trainers get the same field params (JAX init -> params_from_jax, with
the tables scaled up so the encode drives the field) and the same occupancy
bitfield of the analytic scene. The JAX renders run jitted, as the reference
runs them; XLA's FMA contraction there moves positions by an ulp, which the
image tolerance absorbs: 1e-4 for xla/hash and bucket/hash (fp32 on both
sides; the bucket forward is the take-gather), 2e-2 for halo/wrap (the reference's interpreted Pallas kernel rounds its table stack
to bf16).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import TrainState as JTrainState
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch import main_nerf
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.train.checkpoint import params_from_jax
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from seal3d_tpu_torch.train.trainer import Trainer as TTrainer

OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, num_candidates=256,
            coarse_steps=64, occ_stride=4, min_near=0.05)
TCFG = dict(eval_chunk=256, eval_budget_per_ray=48, eval_flat_frac=0.5,
            eval_two_level=True, eval_adaptive=True, eval_tile_chunks=True)


@pytest.fixture(scope="module")
def scene():
    ds = JScene().make_dataset(n_views=2, h=24, w=24, seed=0)
    occ = occupancy_update(occupancy_init(cascades=1), JScene().density,
                           jax.random.PRNGKey(2), bound=1.0,
                           density_thresh=0.01, full=True)
    return ds, occ


def _trainers(scene, backend, gridtype):
    ds, occ = scene
    kw = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
              grid_backend=backend, gridtype=gridtype)
    jtr = JTrainer(jngp, jngp.NGPConfig(**kw), JOpts(**OPTS), JCfg(**TCFG),
                   dataset=ds, key=jax.random.PRNGKey(0))
    jtr.init_state()
    ema = jtr.state.ema_params
    ema = dict(ema, encoder=ema["encoder"] * 5e3,
               encoder_color=ema["encoder_color"] * 5e3)
    jtr.state = jtr.state._replace(
        ema_params=ema, occ=jtr.state.occ._replace(bitfield=occ.bitfield))

    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    ttr = TTrainer(tngp, tngp.NGPConfig(**kw), TOpts(**OPTS), TCfg(**TCFG),
                   dataset=tds)
    ttr.init_state()
    ttr.state = ttr.state._replace(
        ema_params=params_from_jax(jax.tree.map(np.asarray, ema)),
        occ=ttr.state.occ._replace(
            bitfield=torch.from_numpy(np.array(occ.bitfield))))
    return jtr, ttr


def _compare(jtr, ttr, pose, h, w, atol):
    ji, jd = jtr.render_image(pose, h, w)
    ti, td = ttr.render_image(pose, h, w)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=atol)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=atol)
    return ti


@pytest.mark.parametrize("backend,gridtype,atol", [
    ("xla", "hash", 1e-4), ("halo", "wrap", 2e-2), ("bucket", "hash", 1e-4)])
def test_render_image_matches_jax(scene, backend, gridtype, atol):
    ds, _ = scene
    jtr, ttr = _trainers(scene, backend, gridtype)
    img = _compare(jtr, ttr, ds.poses[0], 24, 24, atol)
    st = ttr.render_stats[-1]
    assert st["chunks_rendered"] == 3 and st["samples"] > 0
    assert 0.05 < float(img.std())  # the object is in view


def test_render_image_zero_demand_chunk_skipped(scene):
    """A view with the object in one corner: the chunks that see only
    background have zero demand, are skipped and filled with bg_color, and
    the image still matches the reference. (The rendered chunk stays under
    its budget cap: at the cap, Bresenham thinning selects samples by the
    exact position rounding, where the jitted reference's FMAs differ.)"""
    ds, _ = scene
    jtr, ttr = _trainers(scene, "xla", "hash")
    pose = ds.poses[1].copy()
    pose[:3, 3] += pose[:3, 0] + pose[:3, 1]  # shift the camera sideways
    img = _compare(jtr, ttr, pose, 24, 24, 1e-4)
    st = ttr.render_stats[-1]
    assert st["chunks_skipped"] >= 1 and st["chunks_rendered"] >= 1, st
    assert float(img.min()) < 0.9


def test_main_nerf_test_mode_renders_jax_checkpoint(scene, tmp_path):
    """A JAX .npz checkpoint of the -O config goes through the port's CLI in
    --test mode: state loaded bit for bit, 8 test views written."""
    import optax

    _, occ = scene
    cfg = jngp.NGPConfig(bound=1.0, log2_hashmap_size=12, grid_backend="halo",
                         gridtype="wrap")
    params = jngp.init(jax.random.PRNGKey(1), cfg)
    state = JTrainState(params=params, opt_state=optax.adam(1e-2).init(params),
                        ema_params=params, occ=occ, step=jnp.int32(600))
    path = str(tmp_path / "ngp_step0000600.npz")
    jckpt.save_state(path, state, full=True)

    ws = str(tmp_path / "ws")
    tr = main_nerf.main(["synthetic", "-O", "--test", "--device", "cpu",
                         "--bound", "1.0", "--dt_gamma", "0", "--min_near",
                         "0.05", "--max_steps", "512", "--log2_hashmap_size",
                         "12", "--H", "16", "--W", "16", "--ckpt", path,
                         "--workspace", ws])
    with np.load(path) as data:
        np.testing.assert_array_equal(
            tr.state.ema_params["encoder"].numpy(), data["ema_params/encoder"])
        np.testing.assert_array_equal(tr.state.occ.bitfield.numpy(),
                                      data["occ/bitfield"])
    pngs = sorted(f for f in os.listdir(os.path.join(ws, "results"))
                  if f.endswith(".png"))
    assert len(pngs) == 8
    assert len(tr.render_stats) == 8
    assert all(s["chunks_rendered"] >= 1 for s in tr.render_stats)
