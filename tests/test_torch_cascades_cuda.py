"""K1 on the card at bound 2: the CUDA kernels (forward and backward)
against their plain PyTorch versions on the positions the bound-2 paths
hand them, at the -O widths of NGP at bound 2 (L=16, T=2^15, `wrap`,
finest resolution 4096):
- the packed samples of a single-level train march of `WideSyntheticScene`
  at bench.py's bound-2 recipe (dt_gamma 1/128, 256 candidates, coarse 64),
  over the analytic scene's two-cascade occupancy, some of them on cascade 1;
- a dense-oracle batch: 256 samples a ray (128 stratified, 128 more between
  them) along rays of the same view, clipped to the box.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX: python -m pytest --noconftest -m cuda tests/test_torch_cascades_cuda.py

Without a CUDA device the tests skip (K1 has no CPU or interpret mode).
Tolerances as tests/test_torch_k1_cuda.py holds K1: forward 1e-5 absolute,
backward 1e-5 of the largest gradient entry (fp32 atomics' order).
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.data.rays import get_full_rays
from seal3d_tpu_torch.data.synthetic import WideSyntheticScene
from seal3d_tpu_torch.models.ngp import NGPConfig
from seal3d_tpu_torch.ops.halo_encode import (halo_encode, halo_encode_bwd,
                                              halo_encode_bwd_plain,
                                              halo_encode_plain)
from seal3d_tpu_torch.ops.raymarch import march_rays_flat, near_far_from_aabb
from seal3d_tpu_torch.render.occupancy import occupancy_init, occupancy_update

BOUND = 2.0
BWD_RTOL = 1e-5  # of max |plain gradient|: atomics' summation order


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU or interpret mode)")
    return torch.device("cuda")


def _view(dev):
    scene = WideSyntheticScene()
    ds = scene.make_dataset(n_views=1, h=96, w=96, seed=3, device=dev)
    rays = get_full_rays(torch.as_tensor(ds.poses[0], device=dev),
                         torch.as_tensor(ds.intrinsics, device=dev), 96, 96)
    return scene, rays


def _march_positions(dev):
    """(positions in [0, 1]^3, valid) of one bound-2 train march."""
    scene, rays = _view(dev)
    occ = occupancy_update(occupancy_init(2, device=dev), scene.density,
                           bound=BOUND, density_thresh=0.01,
                           generator=torch.Generator(device=dev).manual_seed(0))
    n = rays["rays_o"].shape[0]
    jitter = torch.rand((n,), generator=torch.Generator(device=dev)
                        .manual_seed(1), device=dev)
    m = march_rays_flat(rays["rays_o"], rays["rays_d"], occ.bitfield,
                        bound=BOUND, cascades=2, dt_gamma=1 / 128,
                        max_steps=512, k=48, budget=n * 48 // 2,
                        num_candidates=256, perturb=jitter, min_near=0.05,
                        occ_stride=4, coarse_steps=64)
    outer = (m.xyzs.abs().amax(-1) > 1.0) & m.valid
    assert int(outer.sum()) > 0, "no sample reached cascade 1"
    return (m.xyzs + BOUND) / (2 * BOUND), m.valid


def _dense_positions(dev):
    """(positions in [0, 1]^3, None) of a dense-oracle batch: 256 samples a
    ray over the box interval of 1024 rays of the view."""
    _, rays = _view(dev)
    ro, rd = rays["rays_o"][::9][:1024], rays["rays_d"][::9][:1024]
    aabb = torch.tensor([-BOUND] * 3 + [BOUND] * 3, device=dev)
    near, far = near_far_from_aabb(ro, rd, aabb, 0.05)
    near, far = near.clamp(max=100.0), far.clamp(max=100.1)
    t = torch.linspace(0.0, 1.0, 256, device=dev)
    z = near[:, None] + (far - near)[:, None] * t[None, :]
    xyz = (ro[:, None] + z[..., None] * rd[:, None]).clamp(-BOUND, BOUND)
    return ((xyz.reshape(-1, 3) + BOUND) / (2 * BOUND)).contiguous(), None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["march", "dense"])
@pytest.mark.parametrize("f", [2, 4])
def test_k1_bound2_matches_plain(cuda_device, case, f):
    cfg = NGPConfig(bound=BOUND, log2_hashmap_size=15, grid_backend="halo",
                    gridtype="wrap").grid
    assert cfg.desired_resolution == 4096
    x, valid = (_march_positions if case == "march"
                else _dense_positions)(cuda_device)
    rng = np.random.default_rng(f)
    tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                           .astype(np.float32)).to(cuda_device)
    before = halo_encode.launches
    with torch.no_grad():
        out = halo_encode(tab, x, valid, cfg)
        ref = halo_encode_plain(tab, x, valid, cfg)
    torch.cuda.synchronize()
    assert halo_encode.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-5
    g = torch.from_numpy(rng.uniform(-1, 1, (x.shape[0], 16 * f))
                         .astype(np.float32)).to(cuda_device)
    n = cfg.total_params
    grad = halo_encode_bwd(g, x, valid, cfg, n)
    plain = halo_encode_bwd_plain(g, x, valid, cfg, n)
    scale = float(plain.abs().max())
    assert scale > 0
    assert float((grad - plain).abs().max()) <= BWD_RTOL * scale
