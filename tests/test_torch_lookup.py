"""Port parity of kernel K5 (`multilevel_lookup`) on the CPU, and of the
'pallas' grid backend's unfused branch that reaches it.

`multilevel_lookup_plain` (the plain PyTorch version the CUDA kernels are
held against on the card) against the JAX package's Pallas kernel run
interpreted (its bf16 table and cotangent bound the agreement at 2e-2) and
against a numpy take (1e-6); `hashgrid_encode` with `backend='pallas'` and
`align_corners=True` or `input_dim=2` against the JAX `xla` backend of the
same geometry (fp32 both: 1e-5), with table gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops import hashgrid as jhg
from seal3d_tpu.ops.pallas.lookup import multilevel_lookup as jlookup
from seal3d_tpu_torch.ops import hashgrid as thg
from seal3d_tpu_torch.ops import lookup as tlk
from test_torch_lookup_cuda import BWD_SET_PAIRS, bwd_index_sets

L, T, F, N = 2, 2**12, 2, 700


def _case(seed=0):
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-1, 1, (L * T, F)).astype(np.float32)
    idx = rng.integers(0, T, (L, N)).astype(np.int32)
    idx[:, :8] = [0, 0, T - 1, T - 1, 5, 5, 5, 127]     # ends and repeats
    g = rng.uniform(-1, 1, (L, N, F)).astype(np.float32)
    return tab, idx, g


def _jax_stack(tab):
    """flat [L*T, F] -> the TPU kernel's [L, F, T/128, 128] stack."""
    return jnp.asarray(tab).reshape(L, T // 128, 128, F).transpose(0, 3, 1, 2)


def test_plain_matches_numpy_take():
    tab, idx, g = _case()
    out = tlk.multilevel_lookup(torch.from_numpy(tab), torch.from_numpy(idx))
    ref = np.stack([tab[l * T + idx[l]] for l in range(L)])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    gtab = tlk.multilevel_lookup_bwd(torch.from_numpy(g),
                                     torch.from_numpy(idx), L * T)
    gref = np.zeros_like(tab)
    for l in range(L):
        np.add.at(gref, l * T + idx[l], g[l])
    np.testing.assert_allclose(gtab.numpy(), gref, atol=1e-6)


def test_plain_matches_interpreted_pallas_kernel():
    """Forward and table gradient against the TPU kernel in interpret mode:
    2e-2, its bf16 rounding of the table (forward) and of the cotangent
    (backward; sums of up to ~4 repeats)."""
    tab, idx, g = _case(1)
    jout, vjp = jax.vjp(lambda s: jlookup(s, jnp.asarray(idx), 1024),
                        _jax_stack(tab))
    (jg,) = vjp(jnp.asarray(g))
    jg = np.asarray(jg).transpose(0, 2, 3, 1).reshape(L * T, F)
    t = torch.from_numpy(tab).requires_grad_()
    out = tlk.multilevel_lookup(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-2)
    np.testing.assert_allclose(t.grad.numpy(), jg, atol=2e-2 * 4)
    assert np.abs(jg).max() > 0.5


@pytest.mark.parametrize("f", [2, 4])
def test_plain_bwd_on_hot_rows_and_mixed_levels(f):
    """multilevel_lookup_bwd_plain on the index sets the card's backward is
    tested on (tests/test_torch_lookup_cuda.py: a hot row, a level in
    ascending row order, dense coarse levels and a hashed one) against a
    float64 np.add.at and against JAX's fp32 `.at[rows].add`: within 1e-5
    of the largest entry (fp32 sums of up to 3,001 terms a row, in another
    order)."""
    for name, idx, t_rows, g in bwd_index_sets(f, BWD_SET_PAIRS, seed=f):
        levels = idx.shape[0]
        rows = (idx.astype(np.int64)
                + np.arange(levels)[:, None] * t_rows).reshape(-1)
        out = tlk.multilevel_lookup_bwd(torch.from_numpy(g),
                                        torch.from_numpy(idx),
                                        levels * t_rows).numpy()
        exact = np.zeros((levels * t_rows, f))
        np.add.at(exact, rows, g.reshape(-1, f).astype(np.float64))
        jx = np.asarray(jnp.zeros((levels * t_rows, f), jnp.float32)
                        .at[jnp.asarray(rows)].add(jnp.asarray(
                            g.reshape(-1, f))))
        scale = np.abs(exact).max()
        assert np.abs(out - exact).max() <= 1e-5 * scale, name
        assert np.abs(out - jx).max() <= 1e-5 * scale, name


def test_wrapper_checks_and_counts():
    tab, idx, g = _case(2)
    with pytest.raises(ValueError, match="unsupported device"):
        tlk.multilevel_lookup(torch.zeros(L * T, F, device="meta"),
                              torch.zeros(L, 4, dtype=torch.int32,
                                          device="meta"))
    with pytest.raises(ValueError, match="equal levels"):
        tlk.multilevel_lookup(torch.zeros(L * T + 1, F),
                              torch.from_numpy(idx))
    before = (tlk.multilevel_lookup.launches,
              tlk.multilevel_lookup_bwd.launches)
    t = torch.from_numpy(tab).requires_grad_()
    tlk.multilevel_lookup(t, torch.from_numpy(idx)).sum().backward()
    assert before == (tlk.multilevel_lookup.launches,
                      tlk.multilevel_lookup_bwd.launches)  # CPU: plain


@pytest.mark.parametrize("kw,f", [
    (dict(num_levels=3, log2_hashmap_size=12, desired_resolution=256,
          align_corners=True), 2),
    (dict(num_levels=3, log2_hashmap_size=12, desired_resolution=256,
          align_corners=True), 4),
    # the geometry of NGP's background grid (models/ngp.py), narrowed
    (dict(num_levels=4, log2_hashmap_size=12, desired_resolution=2048,
          input_dim=2), 2),
    (dict(num_levels=3, log2_hashmap_size=12, desired_resolution=128,
          align_corners=True, gridtype="tiled", interpolation="smoothstep"),
     2),
])
def test_pallas_unfused_branch_matches_jax_xla(kw, f):
    """hashgrid_encode(backend='pallas') through K5's plain version vs the
    JAX `xla` backend over the same geometry: outputs and table gradients
    (brought back to the padded layout) within 1e-5."""
    tc = thg.HashGridConfig(backend="pallas", **kw)
    tx = thg.HashGridConfig(backend="xla", **kw)
    jx = jhg.HashGridConfig(backend="xla", **kw)
    assert not thg._fused_ok(tc)
    rng = np.random.default_rng(7)
    dim = tc.input_dim
    x = np.concatenate([rng.uniform(0, 1, (400, dim)), np.zeros((1, dim)),
                        np.ones((1, dim))]).astype(np.float32)
    native = rng.uniform(-1, 1, (tx.total_params, f)).astype(np.float32)
    padded = thg.convert_table_layout(torch.from_numpy(native), tx, tc)
    ct = rng.uniform(-1, 1, (len(x), tc.num_levels * f)).astype(np.float32)

    t = padded.clone().requires_grad_()
    out = thg.hashgrid_encode(t, torch.from_numpy(x), tc)
    out.backward(torch.from_numpy(ct))
    jout, vjp = jax.vjp(
        lambda tb: jhg.hashgrid_encode(tb, jnp.asarray(x), jx),
        jnp.asarray(native))
    (jg,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    g_native = thg.convert_table_layout(t.grad, tc, tx)
    np.testing.assert_allclose(g_native.numpy(), np.asarray(jg), atol=1e-5)
    # nothing landed in the padding rows
    assert float(t.grad.abs().sum()) == pytest.approx(
        float(g_native.abs().sum()), rel=1e-6)


def test_pallas_fused_geometry_still_takes_the_hash_kernel_path():
    """3-D, align_corners False: the fused branch (K3's plain version), as
    before; its output equals the unfused branch's on the same table."""
    cfg = thg.HashGridConfig(num_levels=3, log2_hashmap_size=12,
                             desired_resolution=256, backend="pallas")
    assert thg._fused_ok(cfg)
    rng = np.random.default_rng(9)
    tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, 2))
                           .astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (200, 3)).astype(np.float32))
    fused = thg.hashgrid_encode(tab, x, cfg)
    unfused = thg.lookup_encode(tab, x, cfg).reshape(200, -1)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), atol=1e-6)
