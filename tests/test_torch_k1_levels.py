"""K1 over a level range and the level-sharded encode, on the CPU.

`halo_encode_levels` is the program one shard of the reference's
`halo_encode_sharded` runs (K1 over the shard's levels, with that range's
scales and resolutions); the port's `halo_encode_sharded` runs every shard
on one device. Here, through the plain versions:

- every shard of n_model in {2, 4} against the matching columns (forward)
  and rows (table gradient) of the whole encode: exact, the arithmetic per
  (sample, level) and the order of the scatter within a level are the same;
- `halo_encode_sharded` (4 x 2) against the JAX function under the virtual
  4 x 2 CPU mesh (interpreted Pallas kernels, bf16 stack: 2e-2 of the
  largest entry) and against the fp32 take-oracle over the JAX package's
  `corner_indices_weights` (1e-5), output and master gradient;
- the two divisibility errors, worded as the reference's;
- the plain backward on coherent samples (ray-ordered, 64 of them inside one
  level-0 cell, ragged M, an all-invalid tail) against the JAX take-oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops.hashgrid import HashGridConfig as JCfg
from seal3d_tpu.ops.hashgrid import corner_indices_weights as j_corners
from seal3d_tpu.ops.hashgrid import hashgrid_encode as j_encode
from seal3d_tpu.parallel.mesh import make_mesh_2d
from seal3d_tpu_torch.ops.halo_encode import (halo_encode, halo_encode_bwd,
                                              halo_encode_levels,
                                              halo_encode_plain,
                                              halo_encode_sharded)
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig as TCfg

# the config of tests/test_parallel.py's halo case: T=2^12 -> wrap period 16
KW = dict(num_levels=8, level_dim=2, base_resolution=16, log2_hashmap_size=12,
          desired_resolution=128, gridtype="wrap", backend="halo")
T = 2**12


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(m, f=2, seed=0):
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-0.5, 0.5, (8 * T, f)).astype(np.float32)
    x = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    g = rng.uniform(-1, 1, (m, 8 * f)).astype(np.float32)
    valid = rng.uniform(size=m) >= 0.2
    return tab, x, g, valid


def _oracle(tab, x, g, valid, jcfg):
    """fp32 take-oracle over the JAX package's corner indices and weights
    -> (output [M, L*F] with invalid rows zero, master gradient of
    sum(output * g))."""
    m, f = x.shape[0], tab.shape[1]
    idx, w = j_corners(jnp.asarray(x), jcfg)
    keep = jnp.asarray(valid)[:, None]

    def encode(t):
        feats = jnp.take(t, idx.reshape(m, -1), axis=0).reshape(m, 8, 8, f)
        out = (feats * w[..., None]).sum(axis=2).reshape(m, -1)
        return jnp.where(keep, out, 0.0)

    out = encode(jnp.asarray(tab))
    grad = jax.grad(lambda t: (encode(t) * g).sum())(jnp.asarray(tab))
    return np.asarray(out), np.asarray(grad)


def _assert_close(a, ref, rtol):
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(a / scale, ref / scale, atol=rtol)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("n_model", [2, 4])
def test_every_shard_equals_its_part_of_the_whole(n_model, f):
    m = 300
    tab, x, g, valid = _inputs(m, f, seed=n_model + f)
    cfg = TCfg(**KW)
    tt, xt, vt, gt = (torch.from_numpy(a) for a in (tab, x, valid, g))
    whole = halo_encode_plain(tt, xt, vt, cfg)                  # [M, L, F]
    whole_grad = halo_encode_bwd(gt, xt, vt, cfg, tab.shape[0])
    per = 8 // n_model
    for j in range(n_model):
        rows = slice(j * per * T, (j + 1) * per * T)
        t = tt[rows].clone().requires_grad_(True)
        out = halo_encode_levels(t, xt, vt, cfg, j * per, per)
        assert out.shape == (m, per, f)
        assert torch.equal(out.detach(), whole[:, j * per:(j + 1) * per])
        out.backward(gt.reshape(m, 8, f)[:, j * per:(j + 1) * per])
        assert torch.equal(t.grad, whole_grad[rows])
        # the same shard written into its columns of the full tensor
        full = torch.full((m, 8, f), 7.0)
        view = halo_encode_levels(tt[rows], xt, vt, cfg, j * per, per,
                                  out=full)
        assert torch.equal(view, out.detach())
        untouched = torch.ones(8, dtype=torch.bool)
        untouched[j * per:(j + 1) * per] = False
        assert (full[:, untouched] == 7.0).all()


def test_level_range_arguments_are_checked():
    tab, x, _, _ = _inputs(8)
    cfg = TCfg(**KW)
    tt, xt = torch.from_numpy(tab), torch.from_numpy(x)
    with pytest.raises(ValueError, match="not a range"):
        halo_encode_levels(tt[:2 * T], xt, None, cfg, 7, 2)
    with pytest.raises(ValueError, match="not a range"):
        halo_encode_levels(tt[:T], xt, None, cfg, 0, 0)
    with pytest.raises(ValueError, match="out must be"):
        halo_encode_levels(tt[:T], xt, None, cfg, 0, 1,
                           out=torch.zeros(8, 4, 2))
    with pytest.raises(ValueError, match="records no gradient"):
        halo_encode_levels(tt[:T].clone().requires_grad_(True), xt, None, cfg,
                           0, 1, out=torch.zeros(8, 8, 2))


def test_sharded_matches_jax_sharded_and_oracle():
    m = 256
    tab, x, g, valid = _inputs(m, seed=3)
    jcfg = JCfg(**KW, shard_levels=True)
    t = torch.from_numpy(tab).requires_grad_(True)
    out = halo_encode_sharded(t, torch.from_numpy(x), torch.from_numpy(valid),
                              TCfg(**KW), 4, 2)
    assert out.shape == (m, 16)
    (out * torch.from_numpy(g)).sum().backward()

    ref_out, ref_grad = _oracle(tab, x, g, valid,
                                dataclasses.replace(jcfg, shard_levels=False))
    _assert_close(out.detach().numpy(), ref_out, 1e-5)
    _assert_close(t.grad.numpy(), ref_grad, 1e-5)

    def loss(tb):
        o = j_encode(tb, jnp.asarray(x), jcfg, valid=jnp.asarray(valid))
        return (o * g).sum(), o

    with jax.sharding.set_mesh(make_mesh_2d(4, 2)):
        (_, j_out), j_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(tab))
    _assert_close(out.detach().numpy(), np.asarray(j_out), 2e-2)
    _assert_close(t.grad.numpy(), np.asarray(j_grad), 2e-2)


def test_sharded_equals_the_whole_encode():
    """n_data = 1: bit for bit; n_data = 2 sums each table row's gradient
    in two parts (1e-6 of the largest entry)."""
    m = 192
    tab, x, g, valid = _inputs(m, seed=4)
    cfg = TCfg(**KW)
    xt, vt, gt = (torch.from_numpy(a) for a in (x, valid, g))

    def run(fn):
        t = torch.from_numpy(tab).requires_grad_(True)
        out = fn(t).reshape(m, -1)
        (out * gt).sum().backward()
        return out.detach(), t.grad

    ref_out, ref_grad = run(lambda t: halo_encode(t, xt, vt, cfg))
    for n_model in (1, 2, 8):
        out, grad = run(lambda t: halo_encode_sharded(t, xt, vt, cfg,
                                                      n_model, 1))
        assert torch.equal(out, ref_out) and torch.equal(grad, ref_grad)
    out, grad = run(lambda t: halo_encode_sharded(t, xt, None, cfg, 4, 2))
    ref_out, ref_grad = run(lambda t: halo_encode(t, xt, None, cfg))
    assert torch.equal(out, ref_out)
    _assert_close(grad.numpy(), ref_grad.numpy(), 1e-6)


def test_sharded_divisibility_errors():
    tab, x, _, _ = _inputs(30)
    cfg = TCfg(**KW)
    tt, xt = torch.from_numpy(tab), torch.from_numpy(x)
    with pytest.raises(ValueError, match=r"num_levels=8 must divide the mesh "
                                         r"'model' axis \(size 3\)"):
        halo_encode_sharded(tt, xt, None, cfg, 3, 2)
    with pytest.raises(ValueError, match=r"batch 30 must divide the mesh "
                                         r"'data' axis \(size 4\)"):
        halo_encode_sharded(tt, xt, None, cfg, 2, 4)


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_plain_backward_on_coherent_samples(interpolation):
    """Ray-ordered samples: 64 consecutive ones inside one level-0 cell
    (0.37..0.41 along a diagonal, cell width 1/15), then a ray crossing the
    box, then a tail of invalid rows; M = 64 + 37 + 20 is ragged. Hundreds
    of terms pile onto the few coarse rows."""
    rng = np.random.default_rng(11)
    s = np.linspace(0.0, 1.0, 64, dtype=np.float32)[:, None]
    a = np.array([0.37, 0.375, 0.38], np.float32)
    one_cell = a + s * np.float32(0.03)
    s = np.linspace(0.0, 1.0, 37, dtype=np.float32)[:, None]
    ray = np.array([0.02, 0.9, 0.1], np.float32) * (1 - s) \
        + np.array([0.97, 0.15, 0.8], np.float32) * s
    x = np.concatenate([one_cell, ray, rng.uniform(0, 1, (20, 3))]
                       ).astype(np.float32)
    m = x.shape[0]
    valid = np.arange(m) < 64 + 37
    tab = rng.uniform(-0.5, 0.5, (8 * T, 4)).astype(np.float32)
    g = rng.uniform(-1, 1, (m, 32)).astype(np.float32)
    cell = np.floor(one_cell * 15 + 0.5)
    assert (cell == cell[0]).all()
    tcfg = TCfg(**KW, interpolation=interpolation)
    got = halo_encode_bwd(torch.from_numpy(g), torch.from_numpy(x),
                          torch.from_numpy(valid), tcfg, tab.shape[0]).numpy()
    _, ref = _oracle(tab, x, g, valid, JCfg(**KW, interpolation=interpolation))
    _assert_close(got, ref, 1e-5)
    # the all-invalid tail alone adds nothing
    tail = halo_encode_bwd(torch.from_numpy(g[-20:]), torch.from_numpy(x[-20:]),
                           torch.zeros(20, dtype=torch.bool), tcfg,
                           tab.shape[0])
    assert not tail.any()
