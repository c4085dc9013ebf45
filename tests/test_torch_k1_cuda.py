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
                                              halo_encode_levels,
                                              halo_encode_plain,
                                              halo_encode_sharded)
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


def _case(cfg, m, f, seed, dev, invalid=0.25):
    rng = np.random.default_rng(seed)
    tab = rng.uniform(-1, 1, (cfg.total_params, f)).astype(np.float32)
    x = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    g = rng.uniform(-1, 1, (m, cfg.num_levels * f)).astype(np.float32)
    valid = rng.uniform(size=m) >= invalid
    return tuple(torch.from_numpy(a).to(dev) for a in (tab, x, g, valid))


def _check_both(tab, x, g, valid, cfg):
    """Forward <= 1e-5, invalid rows zero; backward within BWD_RTOL."""
    n = tab.shape[0]
    with torch.no_grad():
        out = halo_encode(tab, x, valid, cfg)
        ref = halo_encode_plain(tab, x, valid, cfg)
    gk = halo_encode_bwd(g, x, valid, cfg, n)
    gp = halo_encode_bwd_plain(g, x, valid, cfg, n)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    if x.shape[0]:
        assert float((out - ref).abs().max()) <= 1e-5
    if valid is not None:
        assert (out[~valid] == 0).all()
    scale = max(float(gp.abs().max()), 1e-30)
    assert float((gk - gp).abs().max()) <= BWD_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m", [0, 1, 127, 128, 129, 50002])
def test_k1_ragged_sample_counts(cuda_device, m):
    """M below, at and just above one tile of samples, and not a multiple
    of it."""
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15, gridtype="wrap",
                         backend="halo")
    _check_both(*_case(cfg, m, 4, 20 + m % 7, cuda_device), cfg)
    tab, x, g, _ = _case(cfg, m, 2, 30 + m % 7, cuda_device)
    _check_both(tab, x, g, None, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("levels", [1, 16, 32])
def test_k1_level_counts(cuda_device, levels, f):
    """1, 16 and 32 levels (32 levels of F=4 take more than 48 KB of shared
    memory a block)."""
    cfg = HashGridConfig(num_levels=levels, log2_hashmap_size=15,
                         gridtype="wrap", backend="halo")
    _check_both(*_case(cfg, 5000, f, 40 + levels + f, cuda_device), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
def test_k1_level_range_into_the_full_tensor(cuda_device, f):
    """Levels [5, 12) of 16: packed, and with the row stride of the full
    [M, 16, F] tensor (its other columns untouched): bit-identical to those
    columns of the whole encode; the gradient of a strided cotangent within
    BWD_RTOL of the whole gradient's rows; launches counted on
    halo_encode_levels alone."""
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15, gridtype="wrap",
                         backend="halo", interpolation="smoothstep")
    m, t_rows, lo, cnt = 3001, 2**15, 5, 7
    tab, x, g, valid = _case(cfg, m, f, 50 + f, cuda_device)
    rows = slice(lo * t_rows, (lo + cnt) * t_rows)
    before = (halo_encode.launches, halo_encode_bwd.launches,
              halo_encode_levels.launches)
    shard = tab[rows].clone().requires_grad_(True)
    packed = halo_encode_levels(shard, x, valid, cfg, lo, cnt)
    g3 = g.reshape(m, 16, f)
    packed.backward(g3[:, lo:lo + cnt])           # a strided cotangent
    full = torch.full((m, 16, f), 7.0, device=cuda_device)
    view = halo_encode_levels(tab[rows], x, valid, cfg, lo, cnt, out=full)
    torch.cuda.synchronize()
    assert (halo_encode.launches, halo_encode_bwd.launches) == before[:2]
    assert halo_encode_levels.launches == before[2] + 3
    with torch.no_grad():
        whole = halo_encode(tab, x, valid, cfg)
    whole_grad = halo_encode_bwd(g, x, valid, cfg, tab.shape[0])
    assert torch.equal(packed.detach(), whole[:, lo:lo + cnt])
    assert torch.equal(view, whole[:, lo:lo + cnt])
    assert (full[:, :lo] == 7.0).all() and (full[:, lo + cnt:] == 7.0).all()
    scale = float(whole_grad.abs().max())
    err = float((shard.grad - whole_grad[rows]).abs().max())
    assert err <= BWD_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n_model,n_data", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_k1_sharded_reproduces_the_whole(cuda_device, n_model, n_data):
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15, gridtype="wrap",
                         backend="halo")
    m = 4096
    tab, x, g, valid = _case(cfg, m, 4, 60 + n_model, cuda_device)
    tw = tab.clone().requires_grad_(True)
    ref = halo_encode(tw, x, valid, cfg).reshape(m, -1)
    ref.backward(g)
    ts = tab.clone().requires_grad_(True)
    out = halo_encode_sharded(ts, x, valid, cfg, n_model, n_data)
    out.backward(g)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), ref.detach())
    scale = float(tw.grad.abs().max())
    assert float((ts.grad - tw.grad).abs().max()) <= BWD_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
def test_k1_bwd_coherent_ray_ordered_samples(cuda_device, f):
    """Samples ordered ray by ray at the -O march's step (2*sqrt(3)/512 in a
    bound-1 box, 48 per ray) from 2048 rays that cross a small region: long
    runs of lanes in one coarse cell, and thousands of terms on few coarse
    rows. Every third ray's second half is invalid."""
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15, gridtype="wrap",
                         backend="halo")
    rng = np.random.default_rng(70 + f)
    n_rays, k = 2048, 48
    o = rng.uniform(0.35, 0.45, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    step = 2 * np.sqrt(3) / 512 / 2          # in [0, 1] coordinates
    x = (o + d * step * np.arange(k)[None, :, None]).reshape(-1, 3)
    x = np.clip(x, 0, 1).astype(np.float32)
    m = x.shape[0]
    valid = np.ones((n_rays, k), bool)
    valid[::3, k // 2:] = False
    tab = rng.uniform(-1, 1, (cfg.total_params, f)).astype(np.float32)
    g = rng.uniform(-1, 1, (m, 16 * f)).astype(np.float32)
    tab, x, g, valid = (torch.from_numpy(a).to(cuda_device)
                        for a in (tab, x, g, valid.reshape(-1)))
    _check_both(tab, x, g, valid, cfg)
    _check_both(tab, x, g, None, cfg)


@pytest.mark.cuda
def test_k1_all_invalid_tiles(cuda_device):
    """A packed tail: whole tiles of invalid samples give zero features and
    add nothing to the gradient (their cotangent is nonzero), and so does a
    batch with no valid sample at all."""
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15, gridtype="wrap",
                         backend="halo")
    m = 1000
    tab, x, g, _ = _case(cfg, m, 4, 80, cuda_device)
    valid = torch.arange(m, device=cuda_device) < 300
    _check_both(tab, x, g, valid, cfg)
    none = torch.zeros(m, dtype=torch.bool, device=cuda_device)
    with torch.no_grad():
        assert not halo_encode(tab, x, none, cfg).any()
    assert not halo_encode_bwd(g, x, none, cfg, tab.shape[0]).any()
