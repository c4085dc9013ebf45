"""main_nerf's options on the card against the same on the CPU: an
error-map train step (the halo field, so K1 runs forward and backward on
the card), the port's own error-map draw on the card, the NGP background
net, and transmittance-terminated rounds.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX: python -m pytest --noconftest -m cuda
tests/test_torch_nerf_options_cuda.py

Without a CUDA device the tests skip. Tolerances: the step's loss rtol
1e-4, and the error maps within 1e-4 (0.1 of a per-ray error, which K1's
atomics and the bf16 MLPs move by up to ~1e-3 between the devices) with
the same refreshed cells (the last ray to draw a cell sets it on both); the
background net within 1e-5 on all but 1% of rows and 1e-2 on those (a
bf16 rounding flip of the MLP input); renders of the analytic field
within 1e-5 (fp32 on both devices: transcendentals and sums in another
order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.data.rays import (error_map_cells, error_map_inds,
                                        get_full_rays)
from seal3d_tpu_torch.data.synthetic import SyntheticScene
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_bwd
from seal3d_tpu_torch.ops.raymarch import sph_from_ray
from seal3d_tpu_torch.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu_torch.render.renderer import RenderOptions, render_rays
from seal3d_tpu_torch.train.checkpoint import map_tree
from seal3d_tpu_torch.train.trainer import StepRandom, TrainConfig, Trainer

OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05)
HALO = dict(bound=1.0, log2_hashmap_size=15, num_levels=4,
            grid_backend="halo", gridtype="wrap")


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_occ(cuda_device):
    """The synthetic scene's views and its analytic occupancy (CPU)."""
    scene = SyntheticScene()
    ds = scene.make_dataset(n_views=2, h=32, w=32, seed=0)
    occ = occupancy_update(occupancy_init(1), scene.density, 1.0,
                           density_thresh=0.01, full=True,
                           generator=torch.Generator().manual_seed(2))
    return ds, occ


def _to(tree, dev):
    return map_tree(tree, lambda _, t: t.to(dev))


class _Field:
    """The analytic scene as a field module."""

    @staticmethod
    def apply(params, cfg, x, d, valid=None):
        return cfg.density(x), cfg.color(x, d)


@pytest.mark.cuda
def test_error_map_step_on_the_card_matches_cpu(cuda_device, scene_occ):
    ds, occ = scene_occ
    cfg = dict(num_rays=1024, max_steps=100, error_map=True, random_bg=False)
    trainers = []
    for dev in ("cpu", cuda_device):
        tr = Trainer(tngp, tngp.NGPConfig(**HALO),
                     RenderOptions(**OPTS, flat_frac=0.5), TrainConfig(**cfg),
                     dataset=ds, device=dev)
        tr.init_state()
        tr.state = tr.state._replace(occ=_to(occ, dev))
        trainers.append(tr)
    cpu, card = trainers
    # a map with structure, the same on both
    emap = torch.rand((2, 128 * 128),
                      generator=torch.Generator().manual_seed(3))
    cpu.state = cpu.state._replace(error_map=emap.clone())
    card.state = card.state._replace(error_map=emap.to(cuda_device))
    gen = torch.Generator().manual_seed(4)
    inds = error_map_inds(emap[1], ds.h, ds.w, 1024, generator=gen)
    rand = StepRandom(img_idx=torch.tensor(1), inds=inds, bg=None,
                      jitter=torch.rand(1024, generator=gen))
    on_card = StepRandom(*[None if t is None else t.to(cuda_device)
                           for t in rand])
    halo_encode.launches = halo_encode_bwd.launches = 0
    lc = float(card.train_step(on_card)["loss"])
    assert halo_encode.launches == 1 and halo_encode_bwd.launches == 1
    lp = float(cpu.train_step(rand)["loss"])
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    got, want = card.state.error_map.cpu(), cpu.state.error_map
    assert torch.equal(got != emap, want != emap)
    changed = set(torch.nonzero(want[1] != emap[1]).flatten().tolist())
    assert changed <= set(error_map_cells(inds, ds.h, ds.w).tolist())
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_error_map_draw_on_the_card(cuda_device):
    emap = torch.zeros(128 * 128, device=cuda_device)
    hot = torch.tensor([3, 4000, 16000], device=cuda_device)
    emap[hot] = torch.tensor([1.0, 1.0, 2.0], device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    inds = error_map_inds(emap, 512, 384, 8192, generator=gen)
    assert inds.device.type == "cuda" and inds.shape == (8192,)
    assert int(inds.min()) >= 0 and int(inds.max()) < 512 * 384
    cells = error_map_cells(inds, 512, 384)
    share = torch.stack([(cells == c).float().mean() for c in hot]).cpu()
    assert float(share.sum()) == 1.0
    np.testing.assert_allclose(share.numpy(), [0.25, 0.25, 0.5], atol=0.03)


@pytest.mark.cuda
def test_background_net_on_the_card_matches_cpu(cuda_device, scene_occ):
    ds, occ = scene_occ
    cfg = tngp.NGPConfig(**HALO, bg_radius=4.0)
    params = tngp.init(cfg, generator=torch.Generator().manual_seed(5))
    params = dict(params, **{k: params[k] * 5e3 for k in
                             ("encoder", "encoder_color", "encoder_bg")})
    gen = torch.Generator().manual_seed(6)
    o = torch.rand((2**16, 3), generator=gen) * 5 - 2.5
    d = torch.nn.functional.normalize(torch.randn((2**16, 3), generator=gen),
                                      dim=-1)
    sph = sph_from_ray(o, d, cfg.bg_radius)
    want = tngp.background(params, cfg, sph, d)
    got = tngp.background(_to(params, cuda_device), cfg,
                          sph.to(cuda_device), d.to(cuda_device)).cpu()
    off = (got - want).abs().amax(-1)
    assert float((off > 1e-5).float().mean()) <= 1e-2
    assert float(off.max()) <= 1e-2

    opts = RenderOptions(**OPTS, flat_frac=0.5, bg_radius=cfg.bg_radius)
    rays = get_full_rays(torch.from_numpy(ds.poses[0]),
                         torch.from_numpy(ds.intrinsics), ds.h, ds.w)
    want = render_rays(params, tngp, cfg, occ.bitfield, rays["rays_o"],
                       rays["rays_d"], opts)
    halo_encode.launches = 0
    got = render_rays(_to(params, cuda_device), tngp, cfg,
                      occ.bitfield.to(cuda_device),
                      rays["rays_o"].to(cuda_device),
                      rays["rays_d"].to(cuda_device), opts)
    assert halo_encode.launches == 1
    off = (got["image"].cpu() - want["image"]).abs().amax(-1)
    assert float((off > 1e-4).float().mean()) <= 1e-2
    assert float(off.max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("rounds", [2, 4])
def test_term_rounds_on_the_card_match_cpu(cuda_device, scene_occ, rounds,
                                           two_level):
    ds, occ = scene_occ
    opts = RenderOptions(**dict(OPTS, budget_per_ray=64), flat_frac=0.75,
                         term_rounds=rounds)
    if two_level:
        opts = dataclasses.replace(opts, march_two_level=True, tl_group=4,
                                   tl_pool=64, tl_kg=-1, tl_over=2.5)
    scene = SyntheticScene()
    rays = get_full_rays(torch.from_numpy(ds.poses[1]),
                         torch.from_numpy(ds.intrinsics), ds.h, ds.w)
    want = render_rays(None, _Field, scene, occ.bitfield, rays["rays_o"],
                       rays["rays_d"], opts)
    got = render_rays(None, _Field, scene, occ.bitfield.to(cuda_device),
                      rays["rays_o"].to(cuda_device),
                      rays["rays_d"].to(cuda_device), opts)
    assert int(got["num_samples"]) == int(want["num_samples"]) > 0
    for k in ("image", "depth", "weights_sum"):
        err = float((got[k].cpu() - want[k]).abs().max())
        assert err <= 1e-5, (k, err)
