"""Port parity of the leaf ops: the same numpy inputs go through the JAX
reference and the PyTorch port (CPU), compared at the stated tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data import rays as jrays
from seal3d_tpu.ops import bitfield as jbf
from seal3d_tpu.ops import morton as jmorton
from seal3d_tpu.ops.sh import sh_encode as j_sh
from seal3d_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from seal3d_tpu_torch.data import rays as trays
from seal3d_tpu_torch.ops import bitfield as tbf
from seal3d_tpu_torch.ops import morton as tmorton
from seal3d_tpu_torch.ops.sh import sh_encode as t_sh
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp as t_trunc_exp


def test_morton_roundtrip_exact():
    """Bit twiddling: codes and their inverse equal the reference exactly."""
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1024, size=(4096, 3)).astype(np.int32)
    jc = np.asarray(jmorton.morton3d(jnp.asarray(coords))).astype(np.int64)
    tc = tmorton.morton3d(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(tc, jc)
    back = tmorton.morton3d_invert(torch.from_numpy(tc)).numpy()
    np.testing.assert_array_equal(back, coords)
    np.testing.assert_array_equal(
        back, np.asarray(jmorton.morton3d_invert(jnp.asarray(jc, jnp.uint32))))


def test_packbits_and_lookup_exact():
    """Integer ops: the packed bytes and every looked-up bit are exact."""
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(2, jbf.GRID_CELLS)).astype(np.float32)
    jb = np.asarray(jbf.packbits(jnp.asarray(grid), 0.5))
    tb = tbf.packbits(torch.from_numpy(grid), 0.5).numpy()
    np.testing.assert_array_equal(tb, jb)
    cas = rng.integers(0, 2, size=5000).astype(np.int32)
    code = rng.integers(0, jbf.GRID_CELLS, size=5000).astype(np.int32)
    jl = np.asarray(jbf.bitfield_lookup(jnp.asarray(jb), jnp.asarray(cas),
                                        jnp.asarray(code)))
    tl = tbf.bitfield_lookup(torch.from_numpy(tb), torch.from_numpy(cas),
                             torch.from_numpy(code)).numpy()
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    """fp32 polynomials, same constants: 1e-6 absolute."""
    rng = np.random.default_rng(2)
    d = rng.normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(t_sh(torch.from_numpy(d), degree).numpy(),
                               np.asarray(j_sh(jnp.asarray(d), degree)),
                               atol=1e-6)


def test_trunc_exp_forward_and_grad():
    """exp in fp32 (1e-6 relative) and the clamped-exponent gradient."""
    x = np.linspace(-20.0, 20.0, 101).astype(np.float32)
    np.testing.assert_allclose(t_trunc_exp(torch.from_numpy(x)).numpy(),
                               np.asarray(j_trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)
    xt = torch.from_numpy(x).requires_grad_()
    t_trunc_exp(xt).sum().backward()
    jg = jax.grad(lambda v: j_trunc_exp(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6)


def test_get_full_rays():
    """fp32 pixel -> world ray math: 1e-6 absolute on origins and unit
    directions (matrix-vector sums may round in another order)."""
    rng = np.random.default_rng(3)
    from seal3d_tpu.data.provider import rand_poses

    pose = rand_poses(rng, 1, radius=2.2)[0]
    intr = np.array([30.0, 31.0, 12.0, 11.5], np.float32)
    jr = jrays.get_full_rays(jnp.asarray(pose), jnp.asarray(intr), 24, 20)
    tr = trays.get_full_rays(torch.from_numpy(pose), torch.from_numpy(intr),
                             24, 20)
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), atol=1e-6)
