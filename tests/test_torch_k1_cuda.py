"""K1 on the card: the CUDA kernels (forward and backward) against their
plain PyTorch versions.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX, where tests/conftest.py (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_k1_cuda.py

Without a CUDA device the tests skip (K1 has no CPU or interpret mode).
The backward sums with fp32 atomics in an order that changes from run to
run, and the plain version's index_add_ on the card is itself an atomic
scatter, so the two agree to a tolerance relative to the largest entry of
the gradient table: 1e-5 (fp32 sums of up to a few thousand terms per row).
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.ops.halo_encode import (halo_encode, halo_encode_bwd,
                                              halo_encode_bwd_plain,
                                              halo_encode_plain)
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig

BWD_RTOL = 1e-5  # of max |plain gradient|: atomics' summation order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU or interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_k1_matches_plain(cuda_device, f, interpolation):
    """-O widths (L=16, T=2^15), 25% invalid rows: 1e-5 absolute (both fp32,
    only the summation order differs); invalid rows exactly zero; one
    counted launch per call."""
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15, gridtype="wrap",
                         backend="halo", interpolation=interpolation)
    rng = np.random.default_rng(f)
    tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                           .astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.uniform(0, 1, (50000, 3)).astype(np.float32))
    x = torch.cat([x, torch.tensor([[0.0, 0, 0], [1, 1, 1]])]).to(cuda_device)
    valid = torch.from_numpy(rng.uniform(size=x.shape[0]) >= 0.25)
    valid = valid.to(cuda_device)
    before = halo_encode.launches
    with torch.no_grad():
        out = halo_encode(tab, x, valid, cfg)
        ref = halo_encode_plain(tab, x, valid, cfg)
    torch.cuda.synchronize()
    assert halo_encode.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-5
    assert (out[~valid] == 0).all()


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(cuda_device):
    cfg = HashGridConfig(num_levels=4, log2_hashmap_size=12, gridtype="wrap",
                         backend="halo")
    tab = torch.zeros((cfg.total_params, 4), device=cuda_device)
    x = torch.rand((8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        halo_encode(tab, x.double(), None, cfg)           # dtype
    with pytest.raises(ValueError):
        halo_encode(tab[:, :3].contiguous(), x, None, cfg)  # F not 2|4
    g = torch.zeros((8, 4 * 4), device=cuda_device)
    with pytest.raises(ValueError):
        halo_encode_bwd(g.double(), x, None, cfg, cfg.total_params)  # dtype
    with pytest.raises(ValueError):
        halo_encode_bwd(g, x, None, cfg, cfg.total_params - 1)     # n_rows
    # a gradient now flows: through the backward kernel into the table
    tab.requires_grad_(True)
    before = halo_encode_bwd.launches
    (halo_encode(tab, x, None, cfg) ** 2).sum().backward()
    torch.cuda.synchronize()
    assert halo_encode_bwd.launches == before + 1
    assert tab.grad is not None and tab.grad.shape == tab.shape


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_k1_bwd_matches_plain(cuda_device, f, interpolation):
    """-O widths (L=16, T=2^15), 25% invalid rows: the table gradient within
    BWD_RTOL of max |plain|; invalid rows add nothing (their cotangent is
    nonzero); one counted launch per call."""
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15, gridtype="wrap",
                         backend="halo", interpolation=interpolation)
    rng = np.random.default_rng(10 + f)
    m = 50000
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(-1, 1, (m, 16 * f)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=m) >= 0.25)
    x, g, valid = x.to(cuda_device), g.to(cuda_device), valid.to(cuda_device)
    n = cfg.total_params
    before = halo_encode_bwd.launches
    out = halo_encode_bwd(g, x, valid, cfg, n)
    ref = halo_encode_bwd_plain(g, x, valid, cfg, n)
    only_valid = halo_encode_bwd(torch.where(valid[:, None], g, 0.0), x, None,
                                 cfg, n)
    torch.cuda.synchronize()
    assert halo_encode_bwd.launches == before + 2
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((out - ref).abs().max()) <= BWD_RTOL * scale
    assert float((only_valid - ref).abs().max()) <= BWD_RTOL * scale
