"""K4 on the card: the ladder-plan CUDA kernel against its plain PyTorch
version, on rays of the analytic scene and on random rays.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX, where tests/conftest.py (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_ladder_cuda.py

Without a CUDA device the tests skip (the kernel has no CPU or interpret
mode). Kernel and plain version write the same fp32 expressions in the same
order with no FMA contraction, and the demand is a sum of small integers,
exact in any order: t0, far, keep and cnt are bit-identical.

`static_rays` makes, with numpy from a seed, the rays that load each branch
of the kernel (rays from outside, rays that miss the box, rays that start
inside it, axis-aligned rays with zero and negative-zero components); the
CPU tests of tests/test_torch_ladder.py feed the same rays to the plain
version and to the JAX package.
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.data.rays import get_full_rays
from seal3d_tpu_torch.data.synthetic import SyntheticScene
from seal3d_tpu_torch.ops.ladder import (ladder_plan, ladder_plan_plain,
                                         pack_tables)
from seal3d_tpu_torch.render.occupancy import occupancy_init, occupancy_update

KW = dict(bound=1.0, min_near=0.05, max_steps=512, num_candidates=256,
          group=4, n_coarse=32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ladder kernel has no CPU or "
                    "interpret mode)")
    return torch.device("cuda")


def _scene(dev, h=96, w=96):
    scene = SyntheticScene()
    ds = scene.make_dataset(n_views=1, h=h, w=w, seed=5, device=dev)
    occ = occupancy_update(occupancy_init(1, device=dev), scene.density,
                           bound=1.0, density_thresh=0.01,
                           generator=torch.Generator(device=dev).manual_seed(0))
    rays = get_full_rays(torch.as_tensor(ds.poses[0], device=dev),
                         torch.as_tensor(ds.intrinsics, device=dev), h, w)
    return occ, rays["rays_o"].contiguous(), rays["rays_d"].contiguous()


def static_rays(n, seed):
    """(rays_o, rays_d) [n, 3] float32 numpy: by index mod 4, rays from
    radius 3 towards points inside the unit box, rays along lines that pass
    2.0 from its centre (they miss it), rays that start inside it, and
    axis-aligned rays (the other components 0.0 or -0.0) from anywhere in
    [-2.5, 2.5]^3."""
    rng = np.random.default_rng(seed)

    def unit(m):
        v = rng.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    kind = np.arange(n) % 4
    o = 3.0 * unit(n)
    d = rng.uniform(-0.9, 0.9, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    miss = kind == 1
    dm, p = unit(n), unit(n)
    p -= (p * dm).sum(1, keepdims=True) * dm
    p *= 2.0 / np.linalg.norm(p, axis=1, keepdims=True)
    o[miss], d[miss] = (p - 3.0 * dm)[miss], dm[miss]
    inside = kind == 2
    o[inside] = rng.uniform(-0.8, 0.8, (n, 3))[inside]
    d[inside] = unit(n)[inside]
    axis = np.flatnonzero(kind == 3)
    o[axis] = rng.uniform(-2.5, 2.5, (len(axis), 3))
    d[axis] = np.where(rng.uniform(size=(len(axis), 3)) < 0.5, 0.0, -0.0)
    d[axis, rng.integers(0, 3, len(axis))] = rng.choice([-1.0, 1.0],
                                                        len(axis))
    return o.astype(np.float32), d.astype(np.float32)


# (n_coarse, CG) beside the -O eval point's (32, 64), all at group 4
STATICS = [(20, 40), (32, 64), (48, 16)]


def _agree(a, b):
    assert a[2].dtype == torch.bool and a[2].shape == b[2].shape
    for name, x, y in zip(("t0", "far", "keep", "cnt"), a, b):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [32, 64])
def test_k4_matches_plain_on_scene_rays(cuda_device, pool):
    occ, ro, rd = _scene(cuda_device)
    tabs = pack_tables(occ.bitfield, pool)
    aabb = occ.occ_aabb.clamp(-1.0, 1.0)
    group = 4 if pool == 64 else 8
    kw = dict(KW, group=group, pool=pool)
    before = ladder_plan.launches
    out = ladder_plan(ro, rd, *tabs, aabb, **kw)
    torch.cuda.synchronize()
    assert ladder_plan.launches == before + 1
    ref = ladder_plan_plain(ro, rd, *tabs, aabb, **kw)
    _agree(out, ref)
    assert 0 < int(out[2].sum()) < out[2].numel()


@pytest.mark.cuda
def test_k4_random_rays_misses_and_axis_aligned(cuda_device):
    """Random origins in and around the box, random unit directions, rays
    with zero components (the 1e-15 rule) and the render pad ray."""
    occ, _, _ = _scene(cuda_device, 8, 8)
    rng = np.random.default_rng(3)
    ro = rng.uniform(-2.5, 2.5, (20000, 3)).astype(np.float32)
    rd = rng.normal(size=(20000, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[:4] = [[3, 0, 0], [0, 0, -2], [0.1, 0.2, 0.3], [0, 3, 0]]
    rd[:4] = [[1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -0.0, 1]]
    ro, rd = (torch.from_numpy(a).to(cuda_device) for a in (ro, rd))
    tabs = pack_tables(occ.bitfield, 64)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1], device=cuda_device)
    out = ladder_plan(ro, rd, *tabs, aabb, pool=64, **KW)
    ref = ladder_plan_plain(ro, rd, *tabs, aabb, pool=64, **KW)
    _agree(out, ref)
    assert bool((out[0] == 1e9).any()) and bool(out[2].any())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [32, 64])
@pytest.mark.parametrize("n_coarse,cg", STATICS)
def test_k4_statics_and_ragged_counts(cuda_device, n_coarse, cg, pool):
    """Coarse steps and group counts that are not multiples of the warp,
    ray counts that are not multiples of the rays a block takes at once:
    bit-identical to plain on all four outputs."""
    occ, _, _ = _scene(cuda_device, 8, 8)
    tabs = pack_tables(occ.bitfield, pool)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1], device=cuda_device)
    kw = dict(KW, n_coarse=n_coarse, num_candidates=4 * cg, pool=pool)
    ro, rd = (torch.from_numpy(a).to(cuda_device)
              for a in static_rays(32769, seed=n_coarse + pool))
    for n in (1, 31, 33, 32769):
        out = ladder_plan(ro[:n], rd[:n], *tabs, aabb, **kw)
        _agree(out, ladder_plan_plain(ro[:n], rd[:n], *tabs, aabb, **kw))
    assert bool((out[0] == 1e9).any()) and 0 < int(out[2].sum())


@pytest.mark.cuda
def test_k4_refuses_what_it_does_not_take(cuda_device):
    occ, ro, rd = _scene(cuda_device, 8, 8)
    tabs = pack_tables(occ.bitfield, 64)
    aabb = torch.tensor([-1.0, -1, -1, 1, 1, 1], device=cuda_device)
    with pytest.raises(ValueError, match="contiguous f32"):
        ladder_plan(ro.double(), rd, *tabs, aabb, pool=64, **KW)
    with pytest.raises(ValueError, match="contiguous f32"):
        ladder_plan(ro[:, [2, 1, 0]].T.contiguous().T, rd, *tabs, aabb,
                    pool=64, **KW)
    with pytest.raises(ValueError, match="uint8"):
        ladder_plan(ro, rd, tabs[0], tabs[1][:100], tabs[2], aabb, pool=64,
                    **KW)
    with pytest.raises(ValueError, match="uint8"):
        ladder_plan(ro, rd, tabs[0].cpu(), tabs[1], tabs[2], aabb, pool=64,
                    **KW)
    empty = ladder_plan(ro[:0], rd[:0], *tabs, aabb, pool=64, **KW)
    assert empty[2].shape == (0, 64)
