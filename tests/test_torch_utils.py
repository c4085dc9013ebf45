"""The port's shared helpers against the JAX package, on the same numpy
inputs: SH degrees 5-8 (the generic recurrence; values and the gradient of
a weighted sum within 1e-6 of its largest entry), `get_encoder` for every
name (output dims equal, encodes of the same params within 1e-6,
'ash' and unknown names raise alike), `mape_loss`, `huber_loss` and
`eff_distloss` (1e-6, reduced and not), `linear_to_srgb` /
`srgb_to_linear` with their gradients inside and at the clip bounds
(1e-6), and `seed_everything` (the same Python and numpy streams)."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops import encoding as jenc
from seal3d_tpu.ops.sh import sh_encode as j_sh
from seal3d_tpu.utils import color as jcolor
from seal3d_tpu.utils import losses as jloss
from seal3d_tpu.utils.seeding import seed_everything as j_seed
from seal3d_tpu_torch.ops import encoding as tenc
from seal3d_tpu_torch.ops.sh import sh_encode as t_sh
from seal3d_tpu_torch.utils import color as tcolor
from seal3d_tpu_torch.utils import losses as tloss
from seal3d_tpu_torch.utils.seeding import seed_everything as t_seed

TOL = 1e-6


def _dirs(n=257, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]       # poles and the equator
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _vjp_t(fn, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad((fn(xt) * torch.from_numpy(cot)).sum(), xt)
    return g.numpy()


def _vjp_j(fn, x, cot):
    return np.asarray(jax.grad(lambda v: (fn(v) * cot).sum())(jnp.asarray(x)))


@pytest.mark.parametrize("degree", [5, 6, 7, 8])
def test_sh_high_degrees_match_jax(degree):
    d = _dirs(seed=degree)
    want = np.asarray(j_sh(jnp.asarray(d), degree))
    got = t_sh(torch.from_numpy(d), degree).numpy()
    assert got.shape == want.shape == (len(d), degree**2)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())
    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    gt, gj = (_vjp_t(lambda v: t_sh(v, degree), d, cot),
              _vjp_j(lambda v: j_sh(v, degree), d, cot))
    np.testing.assert_allclose(gt, gj, atol=TOL * np.abs(gj).max())


def test_sh_degree_out_of_range_raises():
    with pytest.raises(ValueError):
        t_sh(torch.zeros(2, 3), 9)


@pytest.mark.parametrize("name,input_dim,kw", [
    ("None", 3, {}), ("identity", 2, {}),
    ("frequency", 3, dict(multires=6)), ("freq", 2, dict(multires=4)),
    ("sphere_harmonics", 3, dict(degree=4)), ("SH", 3, dict(degree=6)),
    ("hashgrid", 3, dict(num_levels=4, log2_hashmap_size=12)),
    ("tiledgrid", 3, dict(num_levels=4, log2_hashmap_size=12)),
    ("wrapgrid", 3, dict(num_levels=4, log2_hashmap_size=12)),
    ("hashgrid", 2, dict(num_levels=3, log2_hashmap_size=14,
                         desired_resolution=512)),
])
def test_get_encoder_matches_jax(name, input_dim, kw):
    je = jenc.get_encoder(name, input_dim, **kw)
    te = tenc.get_encoder(name, input_dim, **kw)
    assert (te.name, te.output_dim) == (je.name, je.output_dim)
    rng = np.random.default_rng(3)
    if je.name == "sphere_harmonics":
        x = _dirs(seed=2)
    else:
        x = rng.uniform(0.0, 1.0, (300, input_dim)).astype(np.float32)
    jp = je.init(jax.random.PRNGKey(0))
    tp = te.init(torch.Generator().manual_seed(0), "cpu")
    if jp is None:
        assert tp is None and te.grid_cfg is None
        want = np.asarray(je.encode(None, jnp.asarray(x)))
        got = te.encode(None, torch.from_numpy(x)).numpy()
    else:
        assert tuple(tp.shape) == jp.shape and te.grid_cfg.level_params == \
            tuple(tuple(p) for p in je.grid_cfg.level_params)
        table = np.asarray(jp) * 5e3
        want = np.asarray(je.encode(jnp.asarray(table), jnp.asarray(x)))
        got = te.encode(torch.from_numpy(table), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(x), je.output_dim)
    np.testing.assert_allclose(got, want, atol=TOL * max(np.abs(want).max(),
                                                         1.0))


def test_get_encoder_refusals_match_jax():
    for name, err in (("ash", NotImplementedError), ("nope", ValueError)):
        with pytest.raises(err):
            jenc.get_encoder(name)
        with pytest.raises(err):
            tenc.get_encoder(name)


@pytest.mark.parametrize("reduce", [True, False])
def test_losses_match_jax(reduce):
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(64, 3, 5)).astype(np.float32)
    target = rng.normal(size=(64, 3, 5)).astype(np.float32)
    target[0, 0, 0] = 0.0
    for jf, tf, kw in ((jloss.mape_loss, tloss.mape_loss, {}),
                       (jloss.huber_loss, tloss.huber_loss, {}),
                       (jloss.huber_loss, tloss.huber_loss, dict(delta=0.5))):
        want = np.asarray(jf(jnp.asarray(pred), jnp.asarray(target),
                             reduce=reduce, **kw))
        got = tf(torch.from_numpy(pred), torch.from_numpy(target),
                 reduce=reduce, **kw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    w = rng.uniform(0, 0.2, (32, 24)).astype(np.float32)
    ts = np.sort(rng.uniform(0.1, 3.0, (32, 24)), -1).astype(np.float32)
    dl = rng.uniform(0.01, 0.1, (32, 24)).astype(np.float32)
    want = float(jloss.eff_distloss(jnp.asarray(w), jnp.asarray(ts),
                                    jnp.asarray(dl)))
    got = float(tloss.eff_distloss(torch.from_numpy(w), torch.from_numpy(ts),
                                   torch.from_numpy(dl)))
    assert abs(got - want) <= TOL * abs(want)


@pytest.mark.parametrize("fn", ["linear_to_srgb", "srgb_to_linear"])
def test_color_transforms_match_jax(fn):
    x = np.concatenate([np.linspace(-0.2, 1.2, 301), [0.0, 1.0, 0.0031308,
                                                      0.04045]])
    x = x.astype(np.float32)
    jf, tf = getattr(jcolor, fn), getattr(tcolor, fn)
    want = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    cot = np.ones_like(x)
    inner = (x > 1e-3) & (x < 1.0)     # x ** (1 / 2.4) has no slope at 0
    gt, gj = _vjp_t(tf, x, cot), _vjp_j(jf, x, cot)
    np.testing.assert_allclose(gt[inner], gj[inner], rtol=1e-5, atol=TOL)
    # at and past the clip bounds both packages zero the slope, except where
    # the reference's unselected x ** (1 / 2.4) branch turns 0 * inf into
    # NaN (linear_to_srgb at x <= 0); the port's is NaN at x = 0 alone
    edge = ((x <= 0.0) | (x >= 1.0)) & np.isfinite(gj)
    np.testing.assert_allclose(gt[edge], gj[edge], atol=TOL)
    assert (np.isfinite(gt) | ~np.isfinite(gj)).all()


def test_seed_everything_matches_jax(monkeypatch):
    monkeypatch.setenv("PYTHONHASHSEED", "unset")
    draws = []
    for seed_fn in (j_seed, t_seed):
        seed_fn(1234)
        draws.append((random.random(), np.random.rand(3).tolist(),
                      os.environ["PYTHONHASHSEED"]))
    assert draws[0] == draws[1] and draws[1][2] == "1234"
    t_seed(7)
    a = torch.rand(4)
    t_seed(7)
    assert torch.equal(a, torch.rand(4))
