"""K5 on the card: the lookup CUDA kernels (forward and backward) against
their plain PyTorch versions, alone and through the 'pallas' grid backend's
unfused branch.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX, where tests/conftest.py (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU or interpret
mode). The forward copies rows: exact. The backward sums with fp32 atomics
in an order that changes from run to run (the plain index_add_ on the card
is an atomic scatter too): 1e-5 of the largest gradient entry.

`bwd_index_sets` makes, with numpy from a seed, the index sets that load
the backward's atomics in the ways its paths can: every pair of a level on
one row, a level in ascending row order (a block's range of consecutive
pairs on few rows), and in one call dense coarse levels that would fit a
block's shared memory and a hashed one that would not.
tests/test_torch_lookup.py feeds the same sets to the plain version and to
the JAX package.
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, gather_encode,
                                           hashgrid_encode)
from seal3d_tpu_torch.ops.lookup import (multilevel_lookup,
                                         multilevel_lookup_bwd,
                                         multilevel_lookup_bwd_plain,
                                         multilevel_lookup_plain)

BWD_RTOL = 1e-5
# pairs a level of `bwd_index_sets`, here and in tests/test_torch_lookup.py:
# a level wholly on one row is then a sum of 3,001 fp32 terms, which any
# order keeps within BWD_RTOL (at 300,001 terms one fp32 atomic a pair
# strayed past it on the card, as any sequential fp32 sum may); and the
# backward's 9 blocks take 1,001 pairs each, so their ranges cross level
# edges
BWD_SET_PAIRS = 3001


def bwd_index_sets(f, n, seed=0):
    """[(name, idx [L, n] int32, t_rows, g [L, n, f] float32)]: 'hot rows'
    (T=2^12; level 0 all on row 7; level 1 on rows 0-2999 in ascending
    order, so that each block's range of pairs lands on a few consecutive
    rows), 'mixed levels' (T=2^15: level 0 on 16^3 rows and level 1 on 23^3,
    dense levels of 64 KiB and more at F=4, level 2 on all T rows, as a
    hashed level)."""
    rng = np.random.default_rng(seed)
    hot = np.stack([np.full(n, 7), np.sort(rng.integers(0, 3000, n))])
    t = 2**15
    mixed = np.stack([rng.integers(0, 16**3, n), rng.integers(0, 23**3, n),
                      rng.integers(0, t, n)])
    return [(name, idx.astype(np.int32), t_rows,
             rng.uniform(-1, 1, (len(idx), n, f)).astype(np.float32))
            for name, idx, t_rows in (("hot rows", hot, 2**12),
                                      ("mixed levels", mixed, t))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the lookup kernels have no CPU or "
                    "interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("log2t", [12, 15])
def test_k5_fwd_bwd_match_plain(cuda_device, f, log2t):
    levels, t, n = 8, 2**log2t, 300001
    rng = np.random.default_rng(f + log2t)
    tab = torch.from_numpy(rng.uniform(-1, 1, (levels * t, f))
                           .astype(np.float32)).to(cuda_device)
    idx = rng.integers(0, t, (levels, n)).astype(np.int32)
    idx[0, :1000] = 7                          # a hot row
    idx[:, -2:] = [0, t - 1]
    idx = torch.from_numpy(idx).to(cuda_device)
    g = torch.from_numpy(rng.uniform(-1, 1, (levels, n, f))
                         .astype(np.float32)).to(cuda_device)
    before = (multilevel_lookup.launches, multilevel_lookup_bwd.launches)
    tab.requires_grad_()
    out = multilevel_lookup(tab, idx)
    out.backward(g)
    torch.cuda.synchronize()
    assert (multilevel_lookup.launches, multilevel_lookup_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out.detach(), multilevel_lookup_plain(tab.detach(), idx))
    ref = multilevel_lookup_bwd_plain(g, idx, levels * t)
    assert float((tab.grad - ref).abs().max()) <= BWD_RTOL * float(
        ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_k5_bwd_hot_rows_and_mixed_levels(cuda_device, f, out_of_range):
    """The backward on one row a level takes wholly, on rows in ascending
    order and on dense and hashed levels in one call (blocks' ranges cross
    level edges), with and without out-of-range rows sprinkled in: within
    BWD_RTOL of the largest entry of the plain version fed a float64
    cotangent (out-of-range pairs left out of it)."""
    for name, idx, t_rows, g in bwd_index_sets(f, BWD_SET_PAIRS, seed=f):
        levels = idx.shape[0]
        ok = np.ones(idx.shape, bool)
        if out_of_range:
            rng = np.random.default_rng(f)
            bad = rng.uniform(size=idx.shape) < 0.01
            idx = np.where(bad, rng.choice([-1, -7, t_rows, 2**30],
                                           idx.shape), idx).astype(np.int32)
            ok = ~bad
        ti, tg = (torch.from_numpy(a).to(cuda_device) for a in (idx, g))
        before = multilevel_lookup_bwd.launches
        gk = multilevel_lookup_bwd(tg, ti, levels * t_rows)
        torch.cuda.synchronize()
        assert multilevel_lookup_bwd.launches == before + 1
        tok = torch.from_numpy(ok).to(cuda_device)
        exact = multilevel_lookup_bwd_plain(
            torch.where(tok[..., None], tg.double(), 0.0),
            torch.where(tok, ti, 0), levels * t_rows)
        scale = float(exact.abs().max())
        err = float((gk.double() - exact).abs().max())
        assert err <= BWD_RTOL * scale, (name, err, scale)


@pytest.mark.cuda
def test_k5_out_of_range_rows_read_zero_and_add_nothing(cuda_device):
    levels, t = 2, 4096
    tab = torch.ones((levels * t, 2), device=cuda_device)
    idx = torch.tensor([[0, -1, t, t - 1], [5, 2**30, -7, 1]],
                       dtype=torch.int32, device=cuda_device)
    out = multilevel_lookup(tab, idx)
    assert out[..., 0].tolist() == [[1, 0, 0, 1], [1, 0, 0, 1]]
    gtab = multilevel_lookup_bwd(torch.ones((2, 4, 2), device=cuda_device),
                                 idx, levels * t)
    assert float(gtab.sum()) == 8.0


@pytest.mark.cuda
def test_k5_refuses_what_it_does_not_take(cuda_device):
    tab = torch.zeros((2 * 4096, 2), device=cuda_device)
    idx = torch.zeros((2, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        multilevel_lookup(tab, idx.long())
    with pytest.raises(ValueError, match="int32"):
        multilevel_lookup(tab, idx.cpu())
    with pytest.raises(ValueError, match="width 2 or 4"):
        multilevel_lookup(torch.zeros((2 * 4096, 3), device=cuda_device), idx)
    with pytest.raises(ValueError, match="width 2 or 4"):
        multilevel_lookup(tab.double(), idx)
    with pytest.raises(ValueError, match="cotangent"):
        multilevel_lookup_bwd(torch.zeros((2, 15, 2), device=cuda_device),
                              idx, 2 * 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(num_levels=16, log2_hashmap_size=15, align_corners=True),
    dict(num_levels=4, log2_hashmap_size=19, desired_resolution=2048,
         input_dim=2),
    dict(num_levels=6, log2_hashmap_size=12, align_corners=True,
         gridtype="tiled", interpolation="smoothstep"),
])
def test_pallas_unfused_branch_on_the_card(cuda_device, kw):
    """hashgrid_encode(backend='pallas') where the fused encode does not
    apply: one K5 forward and one K5 backward launch, agreeing with the
    plain gather and its autograd gradient."""
    cfg = HashGridConfig(backend="pallas", **kw)
    rng = np.random.default_rng(5)
    tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, 2))
                           .astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.uniform(0, 1, (30000, cfg.input_dim))
                         .astype(np.float32)).to(cuda_device)
    ct = torch.from_numpy(rng.uniform(-1, 1, (30000, cfg.num_levels * 2))
                          .astype(np.float32)).to(cuda_device)
    before = (multilevel_lookup.launches, multilevel_lookup_bwd.launches)
    t = tab.clone().requires_grad_()
    out = hashgrid_encode(t, x, cfg)
    out.backward(ct)
    assert (multilevel_lookup.launches, multilevel_lookup_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    tp = tab.clone().requires_grad_()
    ref = gather_encode(tp, x, cfg).reshape(30000, -1)
    ref.backward(ct)
    assert float((out - ref).abs().max()) <= 1e-5
    assert float((t.grad - tp.grad).abs().max()) <= BWD_RTOL * float(
        tp.grad.abs().max())
