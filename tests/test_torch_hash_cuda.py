"""K3 / K2 on the card: the hash-encode CUDA kernels (forward and backward)
against their plain PyTorch versions, in both level layouts: 'bucket' at
T=2^19 (native levels, 6,119,864 rows) and 'pallas' at T=2^15 (levels
padded to T).

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX, where tests/conftest.py (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_hash_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU or interpret
mode). The forward differs from the plain version only by summation order:
1e-5 absolute. The backward sums with fp32 atomics in an order that changes
from run to run (the plain index_add_ on the card is an atomic scatter too):
1e-5 of the largest gradient entry.
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.ops.hash_encode import (hash_encode, hash_encode_bwd,
                                              hash_encode_bwd_plain,
                                              hash_encode_plain)
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig, hashgrid_encode

BWD_RTOL = 1e-5  # of max |plain gradient|: atomics' summation order
LAYOUTS = {"bucket": 19, "pallas": 15}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hash-encode kernels have no CPU "
                    "or interpret mode)")
    return torch.device("cuda")


def _cfg(backend, **kw):
    return HashGridConfig(num_levels=16, log2_hashmap_size=LAYOUTS[backend],
                          backend=backend, **kw)


def _points(rng, m, device):
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32))
    return torch.cat([x, torch.tensor([[0.0, 0, 0], [1, 1, 1]])]).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", sorted(LAYOUTS))
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_hash_fwd_matches_plain(cuda_device, backend, f, interpolation):
    """Full NGP widths (L=16), edges included: 1e-5 absolute; one counted
    launch per call."""
    cfg = _cfg(backend, interpolation=interpolation)
    rng = np.random.default_rng(f)
    tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                           .astype(np.float32)).to(cuda_device)
    x = _points(rng, 50000, cuda_device)
    before = hash_encode.launches
    with torch.no_grad():
        out = hash_encode(tab, x, cfg)
        ref = hash_encode_plain(tab, x, cfg)
    torch.cuda.synchronize()
    assert hash_encode.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("backend", sorted(LAYOUTS))
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_hash_bwd_matches_plain(cuda_device, backend, f, interpolation):
    """The table gradient within BWD_RTOL of max |plain|; one counted launch
    per call."""
    cfg = _cfg(backend, interpolation=interpolation)
    rng = np.random.default_rng(10 + f)
    x = _points(rng, 50000, cuda_device)
    g = torch.from_numpy(rng.uniform(-1, 1, (x.shape[0], 16 * f))
                         .astype(np.float32)).to(cuda_device)
    n = cfg.total_params
    before = hash_encode_bwd.launches
    out = hash_encode_bwd(g, x, cfg, n)
    ref = hash_encode_bwd_plain(g, x, cfg, n)
    torch.cuda.synchronize()
    assert hash_encode_bwd.launches == before + 1
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((out - ref).abs().max()) <= BWD_RTOL * scale


@pytest.mark.cuda
def test_hash_align_corners_bucket(cuda_device):
    """align_corners (offset 0, resolution ceil(scale)+1) on the native
    layout, forward and backward."""
    cfg = HashGridConfig(num_levels=8, log2_hashmap_size=14, backend="bucket",
                         align_corners=True)
    rng = np.random.default_rng(3)
    tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, 4))
                           .astype(np.float32)).to(cuda_device)
    x = _points(rng, 20000, cuda_device)
    g = torch.from_numpy(rng.uniform(-1, 1, (x.shape[0], 8 * 4))
                         .astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        err = (hash_encode(tab, x, cfg) - hash_encode_plain(tab, x, cfg))
    assert float(err.abs().max()) <= 1e-5
    out = hash_encode_bwd(g, x, cfg, cfg.total_params)
    ref = hash_encode_bwd_plain(g, x, cfg, cfg.total_params)
    assert float((out - ref).abs().max()) <= BWD_RTOL * float(ref.abs().max())


@pytest.mark.cuda
def test_hash_kernels_refuse_what_they_do_not_take(cuda_device):
    cfg = HashGridConfig(num_levels=4, log2_hashmap_size=12, backend="bucket")
    tab = torch.zeros((cfg.total_params, 4), device=cuda_device)
    x = torch.rand((8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        hash_encode(tab, x.double(), cfg)                     # dtype
    with pytest.raises(ValueError):
        hash_encode(tab[:, :3].contiguous(), x, cfg)          # F not 2|4
    with pytest.raises(ValueError):
        hash_encode(tab[:-8].contiguous(), x, cfg)            # rows
    tiled = HashGridConfig(num_levels=4, log2_hashmap_size=12,
                           backend="bucket", gridtype="tiled")
    with pytest.raises(ValueError):
        hash_encode(tab, x, tiled)                            # gridtype
    with pytest.raises(ValueError):
        hash_encode(tab, x.clone().requires_grad_(), cfg)     # no dx
    g = torch.zeros((8, 4 * 4), device=cuda_device)
    with pytest.raises(ValueError):
        hash_encode_bwd(g.double(), x, cfg, cfg.total_params)  # dtype
    with pytest.raises(ValueError):
        hash_encode_bwd(g, x, cfg, cfg.total_params - 1)       # n_rows
    # a gradient flows: through the backward kernel into the table
    tab.requires_grad_(True)
    before = hash_encode_bwd.launches
    (hash_encode(tab, x, cfg) ** 2).sum().backward()
    torch.cuda.synchronize()
    assert hash_encode_bwd.launches == before + 1
    assert tab.grad is not None and tab.grad.shape == tab.shape


@pytest.mark.cuda
@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_hashgrid_encode_dispatches_to_the_kernel(cuda_device, backend):
    """hashgrid_encode on a CUDA tensor launches the kernel and agrees with
    the plain path; the 'pallas' unfused branch (K5) still raises."""
    cfg = HashGridConfig(num_levels=4, log2_hashmap_size=12, backend=backend)
    tab = torch.rand((cfg.total_params, 2), device=cuda_device)
    x = torch.rand((100, 3), device=cuda_device)
    before = hash_encode.launches
    out = hashgrid_encode(tab, x, cfg)
    assert hash_encode.launches == before + 1
    ref = hash_encode_plain(tab, x, cfg).reshape(100, -1)
    assert float((out - ref).abs().max()) <= 1e-5
    k5 = HashGridConfig(num_levels=4, log2_hashmap_size=12, backend="pallas",
                        align_corners=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hashgrid_encode(torch.rand((k5.total_params, 2), device=cuda_device),
                        x, k5)
