"""Port parity of the NGP field and its checkpoint interchange."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.render.occupancy import occupancy_init as j_occ_init
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu.train.trainer import TrainState as JTrainState
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.occupancy import occupancy_init as t_occ_init
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.trainer import TrainState as TTrainState

SMALL = dict(bound=1.0, log2_hashmap_size=12, num_levels=4)


def _setup(seed=0, **kw):
    jcfg, tcfg = jngp.NGPConfig(**SMALL, **kw), tngp.NGPConfig(**SMALL, **kw)
    jp = jngp.init(jax.random.PRNGKey(seed), jcfg)
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jcfg, tcfg, jp, tp, x, d


def test_params_from_jax_same_tensors():
    jcfg, tcfg, jp, tp, _, _ = _setup(grid_backend="halo", gridtype="wrap")
    jl = {jckpt._path_str(p): np.asarray(a)
          for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tl = dict(tckpt.flatten_tree(tp))
    assert set(jl) == set(tl)
    for k, v in tl.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jl[k])
    # the port's own init draws other numbers with the same shapes
    own = dict(tckpt.flatten_tree(
        tngp.init(tcfg, generator=torch.Generator().manual_seed(0))))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jl.items()}


def test_apply_and_density_match_jax_xla_hash():
    """Tight config (plain gather, reference hashing): the MLP runs on
    bf16-rounded operands in both packages and accumulates in fp32, so only
    the summation order differs: rtol 1e-4 (atol 1e-6 for values near 0)."""
    jcfg, tcfg, jp, tp, x, d = _setup(grid_backend="xla", gridtype="hash")
    js, jc = jngp.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(d))
    ts, tc = tngp.apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    jd = jngp.density(jp, jcfg, jnp.asarray(x))
    td = tngp.density(tp, tcfg, torch.from_numpy(x))
    for k in ("sigma", "geo_feat"):
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                   rtol=1e-4, atol=1e-6)


def test_apply_matches_jax_halo_wrap():
    """-O field (halo/wrap) vs JAX through the interpreted Pallas kernel;
    the reference's bf16 table stack bounds the agreement: 2e-2."""
    jcfg, tcfg, jp, tp, x, d = _setup(grid_backend="halo", gridtype="wrap")
    # std 0.5 tables make the encode, not the init noise, drive the outputs
    jp = dict(jp, encoder=jp["encoder"] * 5e3,
              encoder_color=jp["encoder_color"] * 5e3)
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    valid = np.arange(500) % 5 != 0
    js, jc = jngp.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(d),
                        valid=jnp.asarray(valid))
    ts, tc = tngp.apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(d),
                        valid=torch.from_numpy(valid))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-2)


def test_jax_npz_checkpoint_loads_bit_for_bit(tmp_path):
    """A JAX save_state .npz (full: with optimizer state) loads into the
    port's state with numpy alone, every tensor bit-equal; and the port's
    save_state writes the same keys back."""
    import optax

    jcfg, tcfg, jp, _, _, _ = _setup(seed=3, grid_backend="halo",
                                     gridtype="wrap")
    occ = j_occ_init(1)
    occ = occ._replace(bitfield=(jnp.arange(occ.bitfield.shape[0]) % 251).astype(
                           jnp.uint8),
                       mean_density=jnp.float32(0.25))
    ema = jax.tree.map(lambda a: a * 0.5, jp)
    st = JTrainState(params=jp, opt_state=optax.adam(1e-2).init(jp),
                     ema_params=ema, occ=occ, step=jnp.int32(77))
    path = str(tmp_path / "ngp_step0000077.npz")
    jckpt.save_state(path, st, full=True)

    template = TTrainState(
        params=tngp.init(tcfg, generator=torch.Generator().manual_seed(1)),
        ema_params=tngp.init(tcfg, generator=torch.Generator().manual_seed(2)),
        occ=t_occ_init(1), step=torch.zeros((), dtype=torch.int32))
    loaded = tckpt.load_state(path, template)
    tdtypes = {k: v.dtype for k, v in tckpt.flatten_tree(template)}
    with np.load(path) as data:
        flat = tckpt.flatten_tree(loaded)
        assert {k for k, _ in flat} <= set(data.files)
        for k, v in flat:
            assert v.dtype == tdtypes[k]
            assert v.numpy().dtype == data[k].dtype
            np.testing.assert_array_equal(v.numpy(), data[k])
    # round trip through the port's writer keeps every key and value
    path2 = str(tmp_path / "port.npz")
    tckpt.save_state(path2, loaded)
    with np.load(path) as a, np.load(path2) as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_shape_mismatch_raises(tmp_path):
    _, tcfg, _, tp, _, _ = _setup(grid_backend="xla", gridtype="hash")
    path = str(tmp_path / "p.npz")
    tckpt.save_state(path, {"params": tp})
    other = tngp.init(tngp.NGPConfig(bound=1.0, log2_hashmap_size=13,
                                     num_levels=4))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(path, {"params": other})
