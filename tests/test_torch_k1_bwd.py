"""K1's backward on the CPU: the autograd Function `halo_encode` (whose
backward here is the plain `halo_encode_bwd_plain`) against the JAX package.

- Tight (rtol 1e-5 of the largest entry): the table gradient of the JAX
  take-oracle over `corner_indices_weights` of the same halo config
  (tests/test_ops.py:365-378), and the port's own autograd through the plain
  forward gather. Both sides are fp32; only summation order differs.
- 2e-2 of the largest entry: one small case through the JAX `halo` backend,
  whose interpreted Pallas kernel rounds its table stack and cotangent to
  bf16.
- Invalid rows add nothing to the gradient, even with a nonzero cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops.hashgrid import HashGridConfig as JCfg
from seal3d_tpu.ops.hashgrid import corner_indices_weights as j_corners
from seal3d_tpu.ops.hashgrid import hashgrid_encode as j_encode
from seal3d_tpu_torch.ops.halo_encode import (halo_encode, halo_encode_bwd,
                                              halo_encode_plain)
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig as TCfg

KW = dict(log2_hashmap_size=12, num_levels=4, desired_resolution=256,
          gridtype="wrap", backend="halo")


def _inputs(m, f, seed=0):
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-0.5, 0.5, (JCfg(**KW).total_params, f)).astype(np.float32)
    x = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    g = rng.uniform(-1, 1, (m, 4 * f)).astype(np.float32)
    return tab, x, g


def _port_grad(tab, x, g, cfg, valid=None):
    t = torch.from_numpy(tab).requires_grad_(True)
    v = None if valid is None else torch.from_numpy(valid)
    out = halo_encode(t, torch.from_numpy(x), v, cfg)
    (out.reshape(x.shape[0], -1) * torch.from_numpy(g)).sum().backward()
    return t.grad.numpy()


def _assert_close(a, ref, rtol):
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(a / scale, ref / scale, atol=rtol)


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_table_grad_matches_jax_take_oracle(f, interpolation):
    m = 700
    tab, x, g = _inputs(m, f, seed=f)
    jcfg = JCfg(**KW, interpolation=interpolation)
    idx, w = j_corners(jnp.asarray(x), jcfg)

    def oracle(t):
        feats = jnp.take(t, idx.reshape(m, -1), axis=0).reshape(m, 4, 8, f)
        return ((feats * w[..., None]).sum(axis=2).reshape(m, -1) * g).sum()

    ref = np.asarray(jax.grad(oracle)(jnp.asarray(tab)))
    tcfg = TCfg(**KW, interpolation=interpolation)
    _assert_close(_port_grad(tab, x, g, tcfg), ref, 1e-5)
    # and the plain backward agrees with autograd through the plain gather
    t = torch.from_numpy(tab).requires_grad_(True)
    (halo_encode_plain(t, torch.from_numpy(x), None, tcfg).reshape(m, -1)
     * torch.from_numpy(g)).sum().backward()
    _assert_close(halo_encode_bwd(torch.from_numpy(g), torch.from_numpy(x),
                                  None, tcfg, tab.shape[0]).numpy(),
                  t.grad.numpy(), 1e-6)


def test_table_grad_matches_interpreted_pallas_halo():
    """One small case through the reference's own K1 backward (interpreted
    Pallas, bf16 stack): 2e-2 of the largest entry."""
    m = 300
    tab, x, g = _inputs(m, 4, seed=5)
    jcfg = JCfg(**KW)
    ref = np.asarray(jax.grad(
        lambda t: (j_encode(t, jnp.asarray(x), jcfg) * g).sum())(
            jnp.asarray(tab)))
    _assert_close(_port_grad(tab, x, g, TCfg(**KW)), ref, 2e-2)


def test_invalid_rows_add_no_gradient():
    """Interleaved invalid rows with a nonzero cotangent: the gradient equals
    the one of the valid rows alone (tests/test_ops.py:423-429), and x gets
    no gradient."""
    m = 300
    tab, x, g = _inputs(m, 4, seed=9)
    valid = np.arange(m) % 3 != 1
    cfg = TCfg(**KW)
    got = _port_grad(tab, x, g, cfg, valid=valid)
    ref = _port_grad(tab, x, np.where(valid[:, None], g, 0.0), cfg)
    np.testing.assert_array_equal(got, ref)
    xt = torch.from_numpy(x).requires_grad_(True)
    halo_encode(torch.from_numpy(tab).requires_grad_(True), xt, None,
                cfg).sum().backward()
    assert xt.grad is None
