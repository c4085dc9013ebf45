"""The Seal tools' render-time operations on the card against their CPU
results: `map_mask` and `map_to_origin` of every config of
tests/test_torch_seal_cases.py (line, curve, several strokes, collinear,
dry, anchors) on 4,096 seeded points around each edit, and on 2^18 points
of one busy brush, whose in-bound rows the brush gathers in several blocks.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX: python -m pytest --noconftest -m cuda
tests/test_torch_seal_tools_cuda.py

Without a CUDA device the tests skip. Masks agree exactly except on points
within 1e-6 of a boundary (at most 4 of them); mapped points within 1e-5
(fp32 on both devices, only the order of the small reductions differs).
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.seal import mappers as tmap
from test_torch_seal_cases import CONFIGS, boundary_slack, points_around


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _compare(m_cpu, m_dev, pts, dev):
    dirs = np.random.default_rng(3).normal(size=pts.shape).astype(np.float32)
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    c_pts, c_dirs, c_mask = tmap.map_to_origin(m_cpu, p, d)
    g_pts, g_dirs, g_mask = tmap.map_to_origin(m_dev, p.to(dev), d.to(dev))
    slack = boundary_slack(m_cpu, pts)
    # map_mask (an anchor's tests its box mesh) and map_to_origin's mask (an
    # anchor's is its cone), each against its own CPU result
    for gpu, cpu in ((g_mask.cpu(), c_mask),
                     (tmap.map_mask(m_dev, p.to(dev)).cpu(),
                      tmap.map_mask(m_cpu, p))):
        off = (gpu != cpu).numpy()
        assert (slack[off] < 1e-6).all() and off.sum() <= 4, off.sum()
    agree = (g_mask.cpu() == c_mask).numpy()
    np.testing.assert_allclose(g_pts.cpu().numpy()[agree],
                               c_pts.numpy()[agree], atol=1e-5)
    np.testing.assert_allclose(g_dirs.cpu().numpy(), c_dirs.numpy(),
                               atol=1e-6)
    return c_mask


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mapper_on_the_card_matches_cpu(cuda_device, name):
    m_cpu = tmap.build_mapper(CONFIGS[name])
    m_dev = tmap.build_mapper(CONFIGS[name], device=cuda_device)
    assert all(v.device.type == "cuda" for v in m_dev.data.values())
    pts = points_around(m_cpu, np.random.default_rng(2))
    mask = _compare(m_cpu, m_dev, pts, cuda_device)
    if name != "collinear":   # whose map bound is flat
        assert 0.02 < float(mask.float().mean()) < 0.98


@pytest.mark.cuda
def test_busy_brush_in_blocks_on_the_card(cuda_device, monkeypatch):
    """2^18 points around two strokes, the [N, R] searches in blocks of
    2^14 entries."""
    m_cpu = tmap.build_mapper(CONFIGS["strokes"])
    m_dev = tmap.build_mapper(CONFIGS["strokes"], device=cuda_device)
    pts = points_around(m_cpu, np.random.default_rng(4), 2**18)
    monkeypatch.setattr(tmap, "_PAIR_ENTRIES", 2**14)
    _compare(m_cpu, m_dev, pts, cuda_device)
