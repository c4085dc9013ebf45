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
