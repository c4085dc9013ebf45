"""Port parity of the Seal student at bound 2 (two cascades, the CLI's
default) against the JAX package on the CPU: the pretraining shells over
[-2, 2]^3, the teacher's demand probe and covering bucket, the packed
teacher render against its grid branch and against the reference's, and
the hacked grid update with restore_grid.

The edit moves `WideSyntheticScene`'s satellite ball at (1.45, 0.1, 0.2),
which lies on cascade 1, up by 0.3 (bbox tool). Both students read one
occupancy grid: the analytic scene's two-cascade occupancy from the
reference's full update. The JAX march runs eagerly, as the port does (no
FMA contraction), so demands are exact; shells exact in points, dirs and
weights, their teacher values to 1e-5 on the fp32 `xla` field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.synthetic import WideSyntheticScene as JWide
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops.bitfield import GRID_CELLS
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.seal import mappers as jmap
from seal3d_tpu.seal import renderer as jsr
from seal3d_tpu.seal import trainer as jst
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.seal import mappers as tmap
from seal3d_tpu_torch.seal import renderer as tsr
from seal3d_tpu_torch.seal import trainer as tst
from seal3d_tpu_torch.train.checkpoint import params_from_jax
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cube(center, half, n=3):
    g = np.linspace(-half, half, n)
    return (np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
            + np.asarray(center))


BOUND = 2.0
NGP_KW = dict(bound=BOUND, log2_hashmap_size=12, num_levels=4)
OPTS = dict(bound=BOUND, dt_gamma=1 / 128, num_steps=32, upsample_steps=0,
            min_near=0.05, budget_per_ray=24, num_candidates=256,
            max_steps=256, coarse_steps=32)
TCFG = dict(lr=3e-3, max_steps=100, num_rays=64, eval_chunk=192,
            eval_budget_per_ray=32, random_bg=False)
MOVE = np.eye(4, dtype=np.float32)
MOVE[1, 3] = 0.3
EDIT = {"type": "bbox", "raw": _cube([1.45, 0.1, 0.2], 0.3).tolist(),
        "transform": MOVE.tolist(), "scale": [1.0, 1.0, 1.0]}


def _occupancy():
    """The wide scene's two-cascade occupancy (the reference's full
    update)."""
    return jocc.occupancy_update(jocc.occupancy_init(cascades=2, bound=BOUND),
                                 JWide().density, jax.random.PRNGKey(2),
                                 bound=BOUND, density_thresh=0.01, full=True)


def _pair(opts, ds, occ, params):
    """A JAX and a port SealTrainer over the same teacher params and
    bitfield, their own occupancy state set to `occ`."""
    jcfg, tcfg = jngp.NGPConfig(**NGP_KW), tngp.NGPConfig(**NGP_KW)
    js = jst.SealTrainer(jngp, jcfg, JOpts(**opts), JCfg(**TCFG),
                         jmap.build_mapper(EDIT), teacher_params=params,
                         teacher_bitfield=occ.bitfield, dataset=ds,
                         key=jax.random.PRNGKey(1))
    js.init_state()
    js.state = js.state._replace(
        params=jax.tree.map(jnp.copy, params),
        ema_params=jax.tree.map(jnp.copy, params), occ=occ)
    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    ts = tst.SealTrainer(tngp, tcfg, TOpts(**opts), TCfg(**TCFG),
                         tmap.build_mapper(EDIT),
                         teacher_params=params_from_jax(
                             jax.tree.map(np.asarray, params)),
                         teacher_bitfield=_t(occ.bitfield), dataset=tds,
                         device="cpu")
    ts.init_state()
    tocc = ts.state.occ._replace(**{
        k: _t(getattr(occ, k)) for k in ("density_grid", "bitfield",
                                         "mean_density", "occ_aabb")})
    ts.state = ts.state._replace(
        params=params_from_jax(jax.tree.map(np.asarray, params)),
        ema_params=params_from_jax(jax.tree.map(np.asarray, params)),
        occ=tocc)
    return js, ts


@pytest.fixture(scope="module")
def students():
    """The JAX and port students at bound 2 (two cascades) on two 24x24
    views of the wide scene, teacher params from a JAX init with its tables
    scaled so the encode drives the field, pretraining shells built."""
    ds = JWide().make_dataset(n_views=2, h=24, w=24, seed=0)
    p = jngp.init(jax.random.PRNGKey(0), jngp.NGPConfig(**NGP_KW))
    p = dict(p, encoder=p["encoder"] * 5e3,
             encoder_color=p["encoder_color"] * 5e3)
    js, ts = _pair(OPTS, ds, _occupancy(), p)
    assert ts.opts.cascades == js.opts.cascades == 2
    pkw = dict(epochs=2, batch_size=4096, lr=0.05, local_point_step=0.1,
               local_angle_step=90, surrounding_point_step=0.2,
               global_point_step=0.4)
    js.init_pretraining(jst.PretrainConfig(**pkw))
    ts.init_pretraining(tst.PretrainConfig(**pkw))
    return js, ts, ds


def _cascade1_cells(mapper):
    """The force-fill cells of the edit that lie on cascade 1."""
    cells = tsr.force_fill_cells(mapper.force_fill_bound, 2, BOUND)
    return cells[cells >= GRID_CELLS]


def _bits(bitfield, cells):
    bf = np.asarray(bitfield)
    return (bf[cells >> 3] >> (cells & 7)) & 1


def test_pretraining_shells_match_jax(students):
    """Points, dirs and weights exact over [-2, 2]^3 (the global shell spans
    both cascades); the teacher's sigma and colour to the fp32 field's
    tolerance; the local shell samples the moved ball on cascade 1."""
    js, ts, _ = students
    assert list(ts.pretrain_data) == list(js.pretrain_data) == [
        "local", "surrounding", "global"]
    for k, jv in js.pretrain_data.items():
        tv = ts.pretrain_data[k]
        assert tv["n_batches"] == jv["n_batches"]
        for f in ("points", "dirs", "weight"):
            np.testing.assert_array_equal(tv[f].numpy(), np.asarray(jv[f]),
                                          err_msg=f"{k}/{f}")
        np.testing.assert_allclose(np.log1p(tv["sigma"].numpy()),
                                   np.log1p(np.asarray(jv["sigma"])),
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(tv["color"].numpy(),
                                   np.asarray(jv["color"]), atol=1e-5,
                                   err_msg=k)
    pts = ts.pretrain_data["global"]["points"].reshape(-1, 3)
    assert float(pts.abs().max()) > 1.9
    local = ts.pretrain_data["local"]["points"].reshape(-1, 3)[
        : int(ts.pretrain_data["local"]["weight"].sum())]
    assert float(local[:, 0].min()) > 1.0   # all on cascade 1


def test_teacher_bitfield_holds_the_cascade1_fill(students):
    """The hacked teacher bitfield is the same in both packages and holds
    every force-filled cell, those of cascade 1 included."""
    js, ts, _ = students
    np.testing.assert_array_equal(ts.teacher_bitfield.numpy(),
                                  np.asarray(js.teacher_bitfield))
    c1 = _cascade1_cells(ts.mapper)
    assert len(c1) > 100
    assert _bits(ts.teacher_bitfield.numpy(), c1).all()
    np.testing.assert_array_equal(
        tsr.force_fill_cells(ts.mapper.force_fill_bound, 2, BOUND),
        jsr.force_fill_cells(js.mapper.force_fill_bound, 2, BOUND))


def test_teacher_demand_and_covering_frac_equal(students):
    js, ts, ds = students
    chunk = 192
    jro, jrd, _ = js._teacher_view_setup(ds.poses[0], 24, 24, chunk)
    tro, trd, _ = ts._teacher_view_setup(ds.poses[0], 24, 24, chunk)
    np.testing.assert_allclose(tro.numpy(), np.asarray(jro), atol=1e-6)
    np.testing.assert_allclose(trd.numpy(), np.asarray(jrd), atol=1e-6)
    with jax.disable_jit():   # eager, as the port: no FMA contraction
        jd = [int(js._teacher_demand(js.teacher_bitfield, jro[c], jrd[c]))
              for c in range(jro.shape[0])]
    td = [int(ts._teacher_demand(ts.teacher_bitfield, tro[c], trd[c]))
          for c in range(tro.shape[0])]
    assert td == jd and max(td) > 0
    for need in (0, 1, 100, 1000, 3000, 5000, 6100, 7000):
        assert ts._covering_frac(float(need), chunk) == js._covering_frac(
            float(need), chunk), need


def test_packed_teacher_render_matches_grid_branch_and_jax(students):
    """The probe-driven (packed) teacher view equals its [N, K] grid branch
    at bound 2, and the grid branch equals the reference's."""
    js, ts, ds = students
    n_chunks = -(-24 * 24 // 192)
    img_d, dep_d = ts.render_teacher_view(ds.poses[0], fracs=[None] * n_chunks)
    img_p, dep_p = ts.render_teacher_view(ds.poses[0])
    np.testing.assert_allclose(img_p.numpy(), img_d.numpy(), atol=2e-4)
    np.testing.assert_allclose(dep_p.numpy(), dep_d.numpy(), atol=1e-3)
    tro, trd, _ = ts._teacher_view_setup(ds.poses[0], 24, 24, 192)
    fracs = [ts._covering_frac(float(ts._teacher_demand(
        ts.teacher_bitfield, tro[c], trd[c])), 192) for c in range(n_chunks)]
    assert any(f not in (None, 0.0) for f in fracs), fracs
    jimg, jdep = js.render_teacher_view(ds.poses[0], fracs=[None] * n_chunks)
    np.testing.assert_allclose(img_d.numpy(), jimg, atol=1e-4)
    np.testing.assert_allclose(dep_d.numpy(), jdep, atol=1e-3)
    assert float((img_d.numpy() < 0.99).mean()) > 0.02


def test_hacked_grid_update_and_restore_grid():
    """From one shared grid (the wide scene's occupancy), a hacked full
    update and then restore_grid in both packages. density_scale 0 makes
    the refreshed grid the decayed shared one, whatever the cell jitter:
    the hacked bitfield is bit for bit the reference's, holds every
    force-filled cell of cascade 1 and widens the march AABB to the edit;
    restore_grid gives the reference's un-hacked bitfield."""
    ds = JWide().make_dataset(n_views=2, h=16, w=16, seed=0)
    small = dict(NGP_KW, num_levels=2)
    p = jngp.init(jax.random.PRNGKey(0), jngp.NGPConfig(**small))
    opts = dict(OPTS, density_scale=0.0)
    kw = dict(NGP_KW)
    NGP_KW.update(small)
    try:
        js, ts = _pair(opts, ds, _occupancy(), p)
    finally:
        NGP_KW.clear()
        NGP_KW.update(kw)
    js.update_grid_hacked(jax.random.PRNGKey(7), full=True)
    ts.update_grid_hacked(full=True)
    tb, jb = ts.state.occ.bitfield.numpy(), np.asarray(js.state.occ.bitfield)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts.state.occ.occ_aabb.numpy(),
                                  np.asarray(js.state.occ.occ_aabb))
    c1 = _cascade1_cells(ts.mapper)
    assert _bits(tb, c1).all() and _bits(jb, c1).all()
    aabb = ts.state.occ.occ_aabb.numpy()
    ffb = ts.mapper.force_fill_bound
    assert (aabb[:3] <= ffb[:, 0].min(0)).all()
    assert (aabb[3:] >= ffb[:, 1].max(0)).all()
    hacked = int(np.unpackbits(tb).sum())

    js.restore_grid(jax.random.PRNGKey(11))
    ts.restore_grid()
    tb, jb = ts.state.occ.bitfield.numpy(), np.asarray(js.state.occ.bitfield)
    np.testing.assert_array_equal(tb, jb)
    assert 0 < int(np.unpackbits(tb).sum()) < hacked
    assert not _bits(tb, c1).all()   # the force-fill is gone
