"""K1 on the card: the CUDA kernel against its plain PyTorch version.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX, where tests/conftest.py (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_k1_cuda.py

Without a CUDA device the tests skip (K1 has no CPU or interpret mode).
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_plain
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig


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
    with pytest.raises(RuntimeError, match="backward"):
        halo_encode(tab.requires_grad_(), x, None, cfg)   # no gradient yet
