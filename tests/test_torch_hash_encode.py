"""Port parity of the 'hash' gridtype's encode on the 'pallas' and 'bucket'
backends (kernels K3 and K2), through the plain versions that CPU tensors
take.

References and tolerances:
- the fp32 take-gather over the JAX `corner_indices_weights` of the SAME
  config (its own level offsets): 1e-5 (fp32 both sides);
- the JAX 'bucket' backend (take forward, interpreted K2 backward, f32
  accumulation at HIGHEST precision): forward 1e-6, table gradient rtol 1e-4
  / atol 1e-5, as tests/test_ops.py:276-301 holds it against 'xla';
- a float64 np.add.at scatter for the hot-keys case (rtol 1e-5, atol 1e-4,
  tests/test_ops.py:304-318);
- the JAX 'pallas' backend through the interpreted K3, whose forward casts
  the table to bf16 and whose backward rounds each g*w to bf16: 2e-2.
The configs put level 0 dense (17^3 < T), so the padded and native layouts
differ there. The inputs of tests/test_torch_hash_cases.py (ray-ordered runs
in one cell, runs across warp edges, cells whose corners collide in the
hash; the `cuda` tests feed the kernels the same) go through the plain
versions against the JAX 'xla' and 'bucket' backends at the tolerances
above.
"""

import dataclasses

import test_torch_hash_cases as hash_cases
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops import hashgrid as jhg
from seal3d_tpu_torch.ops import hashgrid as thg
from seal3d_tpu_torch.ops.hash_encode import (hash_encode, hash_encode_bwd,
                                              hash_encode_bwd_plain,
                                              hash_encode_plain)

SMALL = dict(num_levels=4, desired_resolution=512, log2_hashmap_size=13)


def _cfgs(**kw):
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def _inputs(total, m=300, f=2, seed=0, std=0.5):
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-std, std, size=(total, f)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, size=(m, 3)).astype(np.float32)
    # the edges, where the position clamp and the top-corner clip act
    x[:3] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5]]
    return tab, x


def _take_oracle(tab, x, jcfg):
    """The JAX take-gather over corner_indices_weights -> [M, L*F] jnp."""
    idx, w = jhg.corner_indices_weights(jnp.asarray(x), jcfg)
    m = x.shape[0]
    f = jnp.take(jnp.asarray(tab), idx.reshape(m, -1), axis=0).reshape(
        m, jcfg.num_levels, 8, -1)
    return (f * w[..., None]).sum(axis=2).reshape(m, -1)


@pytest.mark.parametrize("backend", ["pallas", "bucket"])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_plain_forward_matches_take_oracle(backend, f, interpolation):
    jc, tc = _cfgs(**SMALL, backend=backend, interpolation=interpolation)
    assert tc.level_params == jc.level_params
    tab, x = _inputs(tc.total_params, f=f, seed=f)
    ref = np.asarray(_take_oracle(tab, x, jc))
    t, xt = torch.from_numpy(tab), torch.from_numpy(x)
    out = hash_encode_plain(t, xt, tc).reshape(300, -1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # the dispatching wrappers take the plain version for CPU tensors
    np.testing.assert_array_equal(hash_encode(t, xt, tc).reshape(300, -1),
                                  out.numpy())
    np.testing.assert_array_equal(thg.hashgrid_encode(t, xt, tc).numpy(),
                                  out.numpy())


def test_layouts_differ_where_levels_are_dense():
    """The two layouts of one geometry: pallas pads the dense level 0 to T,
    bucket sizes it natively (8-aligned), hashed levels are T in both."""
    _, pal = _cfgs(**SMALL, backend="pallas")
    _, buc = _cfgs(**SMALL, backend="bucket")
    (r0, _, n_p, h0, _), (_, _, n_b, _, _) = pal.level_params[0], \
        buc.level_params[0]
    assert not h0 and n_p == 2**13 and n_b == ((r0**3 + 7) // 8) * 8 < n_p
    assert all(h and n == 2**13 for _, _, n, h, _ in buc.level_params[1:])
    full = thg.HashGridConfig(backend="bucket")   # the reference's capacity
    assert full.total_params == 6_119_864


def test_bucket_matches_jax_bucket_backend():
    """Forward 1e-6 against the JAX bucket backend's take; the table
    gradient through its interpreted K2 (sorted-bucket scatter) at rtol 1e-4
    / atol 1e-5, as the reference's own test holds K2."""
    kw = dict(num_levels=4, level_dim=2, base_resolution=4,
              desired_resolution=64, log2_hashmap_size=14, backend="bucket")
    jc, tc = _cfgs(**kw)
    tab, x = _inputs(tc.total_params, m=173, seed=1)

    def jloss(tb):
        return (jhg.hashgrid_encode(tb, jnp.asarray(x), jc) ** 2).sum()

    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(tab), jnp.asarray(x), jc))
    gref = np.asarray(jax.grad(jloss)(jnp.asarray(tab)))
    t = torch.from_numpy(tab).requires_grad_()
    out = thg.hashgrid_encode(t, torch.from_numpy(x), tc)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), gref, rtol=1e-4, atol=1e-5)


def test_bwd_hot_keys():
    """A third of the samples at one point (so a third of every level's
    requests hit the same 8 entries): every request lands, against a
    float64 np.add.at over the JAX corner indices and weights."""
    jc, tc = _cfgs(**SMALL, backend="bucket")
    rng = np.random.default_rng(3)
    m, f = 3000, 4
    x = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    x[: m // 3] = [0.3, 0.6, 0.2]
    g = rng.normal(size=(m, 4 * f)).astype(np.float32)
    idx, w = (np.asarray(a) for a in
              jhg.corner_indices_weights(jnp.asarray(x), jc))
    ref = np.zeros((tc.total_params, f), np.float64)
    np.add.at(ref, idx.reshape(-1),
              (w[..., None].astype(np.float64)
               * g.reshape(m, 4, 1, f)).reshape(-1, f))
    got = hash_encode_bwd_plain(torch.from_numpy(g), torch.from_numpy(x), tc,
                                tc.total_params)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        hash_encode_bwd(torch.from_numpy(g), torch.from_numpy(x), tc,
                        tc.total_params).numpy(), got.numpy())


def test_pallas_matches_interpreted_k3():
    """The JAX pallas backend through the interpreted K3 (bf16 table in the
    forward, bf16 g*w in the backward): forward and table gradient (relative
    to its largest entry) at 2e-2."""
    jc, tc = _cfgs(num_levels=4, desired_resolution=256, log2_hashmap_size=12,
                   backend="pallas")
    tab, x = _inputs(tc.total_params, f=4, seed=2)
    g = np.random.default_rng(5).normal(size=(300, 16)).astype(np.float32)

    def jloss(tb):
        return (jhg.hashgrid_encode(tb, jnp.asarray(x), jc) * g).sum()

    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(tab), jnp.asarray(x), jc))
    gref = np.asarray(jax.grad(jloss)(jnp.asarray(tab)))
    t = torch.from_numpy(tab).requires_grad_()
    out = thg.hashgrid_encode(t, torch.from_numpy(x), tc)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-2)
    scale = float(np.abs(gref).max())
    np.testing.assert_allclose(t.grad.numpy() / scale, gref / scale,
                               atol=2e-2)


@pytest.mark.parametrize("name", ["xla", "halo", "pallas", "bucket"])
def test_registry_kernel_path_is_plain_on_cpu(name):
    """Every backend of the registry: its kernel wrapper takes the plain
    path on a CPU tensor, bit for bit, and hashgrid_encode dispatches to
    it."""
    kw = dict(SMALL, backend=name)
    if name == "halo":   # K1 takes the wrap gridtype at T = P^3
        kw.update(log2_hashmap_size=12, gridtype="wrap")
    _, tc = _cfgs(**kw)
    entry = thg.backends()[name]
    tab, x = _inputs(tc.total_params, f=4, seed=7)
    t, xt = torch.from_numpy(tab), torch.from_numpy(x)
    valid = torch.arange(300) % 4 != 0
    plain = entry.plain(t, xt, valid, tc)
    np.testing.assert_array_equal(entry.encode(t, xt, valid, tc).numpy(),
                                  plain.numpy())
    np.testing.assert_array_equal(
        thg.hashgrid_encode(t, xt, tc, valid=valid).numpy(),
        plain.reshape(300, -1).numpy())
    assert (entry.kernel is None) == (name == "xla")


def test_hash_encode_refuses_what_it_does_not_take():
    _, tc = _cfgs(**SMALL, backend="bucket")
    tab = torch.zeros(tc.total_params, 2)
    # positions that require a gradient are taken: 'bucket' gives them the
    # reference's dx, the fused 'pallas' backend none (test_torch_dnerf.py
    # holds both against jax.grad)
    for backend, has_dx in (("bucket", True), ("pallas", False)):
        x = torch.rand(4, 3, requires_grad=True)
        cfg = dataclasses.replace(tc, backend=backend)
        t = torch.rand(cfg.total_params, 2)
        hash_encode(t, x, cfg).sum().backward()
        assert (x.grad is not None) == has_dx, backend
    with pytest.raises(ValueError):
        hash_encode(tab.to("meta"), torch.zeros(4, 3, device="meta"), tc)
    with pytest.raises(ValueError):
        hash_encode_bwd(torch.zeros(4, 8, device="meta"),
                        torch.zeros(4, 3, device="meta"), tc, tc.total_params)
    halo_on_hash = dataclasses.replace(tc, backend="halo")
    with pytest.raises(ValueError, match="wrap"):
        thg.hashgrid_encode(tab, torch.rand(4, 3), halo_on_hash)
    with pytest.raises(ValueError, match="unknown grid backend"):
        thg.hashgrid_encode(tab, torch.rand(4, 3),
                            dataclasses.replace(tc, backend="mxu"))


@pytest.mark.parametrize("src,dst", [("xla", "pallas"), ("pallas", "xla"),
                                     ("bucket", "pallas")])
def test_convert_table_layout_matches_jax(src, dst):
    """Re-packing between the native and padded layouts equals the JAX
    function's, and a padded table encodes the same as its native
    conversion (padding rows are never addressed)."""
    jsrc, tsrc = _cfgs(**SMALL, backend=src)
    jdst, tdst = _cfgs(**SMALL, backend=dst)
    tab, x = _inputs(tsrc.total_params, f=2, seed=4)
    ref = np.asarray(jhg.convert_table_layout(jnp.asarray(tab), jsrc, jdst))
    out = thg.convert_table_layout(torch.from_numpy(tab), tsrc, tdst)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.shape == (tdst.total_params, 2)
    np.testing.assert_array_equal(
        hash_encode_plain(out, torch.from_numpy(x), tdst).numpy(),
        hash_encode_plain(torch.from_numpy(tab), torch.from_numpy(x),
                          tsrc).numpy())
    with pytest.raises(ValueError, match="hashmap"):
        thg.convert_table_layout(out, tdst,
                                 dataclasses.replace(tsrc, log2_hashmap_size=12))


@pytest.mark.parametrize("case", sorted(hash_cases.CASES))
@pytest.mark.parametrize("jbackend", ["xla", "bucket"])
def test_run_and_collision_inputs_match_jax(case, jbackend):
    """Samples in long runs inside one cell, runs that straddle warp edges
    and cells with colliding corners: the port's 'bucket' encode (plain
    version) against the JAX 'xla' backend (autodiff gradient) and 'bucket'
    backend (interpreted K2), fp32: forward 1e-6, table gradient rtol 1e-4 /
    atol 1e-5 of a gradient scaled to a largest entry of 1."""
    jc, tc = _cfgs(**SMALL, backend=jbackend)
    _, bc = _cfgs(**SMALL, backend="bucket")
    assert bc.level_params == tc.level_params      # one native layout
    x = hash_cases.CASES[case](bc.level_params)
    rng = np.random.default_rng(9)
    tab = rng.uniform(-0.5, 0.5, (bc.total_params, 4)).astype(np.float32)
    g = rng.normal(size=(x.shape[0], 4 * 4)).astype(np.float32)

    def jloss(tb):
        return (jhg.hashgrid_encode(tb, jnp.asarray(x), jc) * g).sum()

    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(tab), jnp.asarray(x), jc))
    gref = np.asarray(jax.grad(jloss)(jnp.asarray(tab)))
    t = torch.from_numpy(tab).requires_grad_()
    out = thg.hashgrid_encode(t, torch.from_numpy(x), bc)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    scale = float(np.abs(gref).max())
    assert scale > 0
    np.testing.assert_allclose(t.grad.numpy() / scale, gref / scale,
                               rtol=1e-4, atol=1e-5)


def test_colliding_cells_share_a_row():
    """The collision input is what it says: in each pair the two cells
    differ and their corners 0 index one row of the finest level, by the
    port's own `corner_indices_weights`."""
    _, tc = _cfgs(**SMALL, backend="bucket")
    x, level, cells = hash_cases.colliding_cells(tc.level_params)
    idx, _ = thg.corner_indices_weights(torch.from_numpy(x), tc)
    rows = idx[:, level, 0].reshape(len(cells), 4, -1)   # a, b, a, b runs
    assert (rows == rows[:, :1, :1]).all()
    assert (cells[:, 0] != cells[:, 1]).any(-1).all()
