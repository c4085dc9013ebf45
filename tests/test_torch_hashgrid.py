"""Port parity of the hash-grid encoder and kernel K1's plain version.

The tight reference for the 'wrap' grid is the take-gather over the JAX
`corner_indices_weights` of the SAME halo config (tests/test_ops.py's
oracle), not `backend="xla"`: xla sizes coarse levels min(dense, T), and
then wrap_period is 0 and those levels index as 'tiled'. One case also runs
the JAX halo backend through the interpreted Pallas kernel, whose bf16 stack
bounds the agreement at 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops import hashgrid as jhg
from seal3d_tpu_torch.ops import hashgrid as thg
from seal3d_tpu_torch.ops.halo_encode import (halo_encode, halo_encode_plain)

HALO = dict(log2_hashmap_size=12, num_levels=4, desired_resolution=256,
            gridtype="wrap", backend="halo")


def _cfgs(**kw):
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def _inputs(m=300, f=2, seed=0, total=None, std=0.5):
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-std, std, size=(total, f)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, size=(m, 3)).astype(np.float32)
    return tab, x


def _take_oracle(tab, x, jcfg):
    """The JAX take-gather over corner_indices_weights -> [M, L*F] jnp."""
    idx, w = jhg.corner_indices_weights(jnp.asarray(x), jcfg)
    m = x.shape[0]
    f = jnp.take(jnp.asarray(tab), idx.reshape(m, -1), axis=0).reshape(
        m, jcfg.num_levels, 8, -1)
    return (f * w[..., None]).sum(axis=2).reshape(m, -1)


@pytest.mark.parametrize("kw", [
    dict(),                                                  # NGP plain mode
    dict(log2_hashmap_size=15, gridtype="wrap", backend="halo"),  # -O
    dict(log2_hashmap_size=15, gridtype="wrap", backend="xla"),
    dict(HALO),
    dict(log2_hashmap_size=12, num_levels=4, gridtype="tiled"),
    dict(desired_resolution=4096, backend="pallas"),
])
def test_level_params_equal(kw):
    """The table layout: every level tuple equal, so checkpoints interchange."""
    jc, tc = _cfgs(**kw)
    assert tc.level_params == jc.level_params
    assert tc.total_params == jc.total_params


@pytest.mark.parametrize("gridtype,backend", [
    ("wrap", "halo"), ("wrap", "xla"), ("hash", "xla"), ("tiled", "xla")])
def test_corner_indices_weights(gridtype, backend):
    """Indices exact; weights 1e-6 (fp32 products of the same fractions)."""
    jc, tc = _cfgs(log2_hashmap_size=12, num_levels=6,
                   desired_resolution=512, gridtype=gridtype, backend=backend)
    rng = np.random.default_rng(4)
    # include the edges, where the clamp and the top-corner clip act
    x = np.concatenate([rng.uniform(0, 1, (500, 3)),
                        [[0, 0, 0], [1, 1, 1], [1, 0, 0.5]]]).astype(np.float32)
    ji, jw = jhg.corner_indices_weights(jnp.asarray(x), jc)
    ti, tw = thg.corner_indices_weights(torch.from_numpy(x), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("f", [2, 4])
def test_halo_plain_matches_take_oracle(f):
    """K1's plain version vs the JAX take-oracle over the same wrap indexing
    (F=2 sigma grid, F=4 stacked grids): fp32 both, 1e-5 absolute."""
    jc, tc = _cfgs(**HALO)
    tab, x = _inputs(f=f, total=tc.total_params)
    ref = np.asarray(_take_oracle(tab, x, jc))
    out = halo_encode_plain(torch.from_numpy(tab), torch.from_numpy(x), None, tc)
    np.testing.assert_allclose(out.reshape(300, -1).numpy(), ref, atol=1e-5)
    # the dispatching wrapper takes the plain version for CPU tensors
    out2 = thg.hashgrid_encode(torch.from_numpy(tab), torch.from_numpy(x), tc)
    np.testing.assert_array_equal(out2.numpy(), out.reshape(300, -1).numpy())


def test_halo_matches_interpreted_pallas_kernel():
    """Port halo encode vs JAX hashgrid_encode(backend='halo') through the
    interpreted Pallas kernel (bf16 stack inside: 2e-2), with a valid mask."""
    jc, tc = _cfgs(**HALO)
    tab, x = _inputs(f=4, total=tc.total_params, seed=1)
    valid = np.arange(300) % 3 != 1
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(tab), jnp.asarray(x), jc,
                                         valid=jnp.asarray(valid)))
    out = thg.hashgrid_encode(torch.from_numpy(tab), torch.from_numpy(x), tc,
                              valid=torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2)


def test_halo_invalid_rows_exact_zero_and_valid_rows_unchanged():
    _, tc = _cfgs(**HALO)
    tab, x = _inputs(f=4, total=tc.total_params, seed=2)
    t, xt = torch.from_numpy(tab), torch.from_numpy(x)
    valid = torch.arange(300) < 180
    full = halo_encode(t, xt, None, tc)
    masked = halo_encode(t, xt, valid, tc)
    assert (masked[~valid] == 0).all()
    np.testing.assert_array_equal(masked[valid].numpy(), full[valid].numpy())


def test_xla_backend_matches_jax_xla():
    """Plain gather encode (hash gridtype, reference hashing): 1e-5."""
    jc, tc = _cfgs(log2_hashmap_size=12, num_levels=6, desired_resolution=512)
    tab, x = _inputs(f=2, total=tc.total_params, seed=3)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(tab), jnp.asarray(x), jc))
    out = thg.hashgrid_encode(torch.from_numpy(tab), torch.from_numpy(x), tc)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_halo_plain_gradient_matches_oracle_gradient():
    """The plain version is differentiable: its table gradient equals the
    JAX take-oracle's (1e-5)."""
    jc, tc = _cfgs(**HALO)
    tab, x = _inputs(f=2, total=tc.total_params, seed=5)
    t = torch.from_numpy(tab).requires_grad_()
    (halo_encode_plain(t, torch.from_numpy(x), None, tc) ** 2).sum().backward()
    gr = jax.grad(lambda tb: (_take_oracle(tb, x, jc) ** 2).sum())(jnp.asarray(tab))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gr), atol=1e-5)


def test_unported_backends_raise():
    """Every backend of the reference is ported: the 'pallas' backend's
    unfused branch (align_corners: kernel K5), the last to raise, now
    encodes and agrees with the JAX `xla` backend of the same geometry
    (1e-5; tests/test_torch_lookup.py holds the gradients too). Level
    sharding without a mesh encodes the uniform [L*T, F] stack whole, as
    the JAX `xla` backend does with shard_levels and no ambient mesh
    (`constrain` a no-op there); an unknown backend raises."""
    kw = dict(log2_hashmap_size=12, num_levels=2, align_corners=True)
    jc, tc = _cfgs(backend="pallas", **kw)
    jx, _ = _cfgs(backend="xla", **kw)
    tab, x = _inputs(f=2, total=tc.total_params, seed=6)
    out = thg.hashgrid_encode(torch.from_numpy(tab), torch.from_numpy(x), tc)
    native = thg.convert_table_layout(torch.from_numpy(tab), tc,
                                      thg.HashGridConfig(backend="xla", **kw))
    ref = jhg.hashgrid_encode(jnp.asarray(native.numpy()), jnp.asarray(x), jx)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    jsh, tsh = _cfgs(shard_levels=True, **kw)
    uniform, _ = _inputs(f=2, total=tsh.total_params, seed=7)
    out = thg.hashgrid_encode(torch.from_numpy(uniform), torch.from_numpy(x),
                              tsh)
    ref = jhg.hashgrid_encode(jnp.asarray(uniform), jnp.asarray(x), jsh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError, match="unknown grid backend"):
        thg.hashgrid_encode(torch.from_numpy(tab), torch.from_numpy(x),
                            thg.HashGridConfig(backend="nope", **kw))


def test_kernel_refuses_unsupported_device():
    _, tc = _cfgs(**HALO)
    with pytest.raises(ValueError):
        halo_encode(torch.zeros(tc.total_params, 2, device="meta"),
                    torch.zeros(4, 3, device="meta"), None, tc)
