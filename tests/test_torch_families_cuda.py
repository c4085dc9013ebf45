"""The D-NeRF, CCNeRF and SDF paths on the card against the same on the CPU
(the plain versions): D-NeRF's field through K1 at full -O width and one
train step's loss and gradient, the time-grid update on given cells, the
`bucket` encode's positions' gradient beside K2, CCNeRF's residual field
and SDF's field and labels.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX: python -m pytest --noconftest -m cuda
tests/test_torch_families_cuda.py

Without a CUDA device the tests skip. Tolerances: CCNeRF's field within
1e-5 (fp32, summation order only); the bucket dx within 1e-5 of its
largest entry; the MLPs round to bf16, so an fp32 ulp between the devices
can flip a rounding: the D-NeRF warp, sigma and colour and SDF's output
within 1e-5 of the largest value on all but 1% of rows and within 1e-2 on
those, gradients within 1e-2 of each leaf's largest entry; the time grid's
densities rtol 1e-4 and its bitfields equal but for 0.1% of cells.
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.data.sdf_provider import SDFDataset
from seal3d_tpu_torch.data.synthetic import DynamicSyntheticScene
from seal3d_tpu_torch.models import ccnerf, dnerf, sdf
from seal3d_tpu_torch.ops.halo_encode import halo_encode
from seal3d_tpu_torch.ops.hash_encode import bucket_dx, hash_encode
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig
from seal3d_tpu_torch.render.occupancy import (occupancy_t_init,
                                               occupancy_t_update)
from seal3d_tpu_torch.render.renderer import RenderOptions
from seal3d_tpu_torch.seal.geometry import box_mesh_from_aabb
from seal3d_tpu_torch.train.checkpoint import flatten_tree, map_tree
from seal3d_tpu_torch.train.dnerf_trainer import DNeRFTrainer
from seal3d_tpu_torch.train.trainer import StepRandom, TrainConfig

OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05)
O_FIELD = dict(bound=1.0, log2_hashmap_size=15, grid_backend="halo",
               gridtype="wrap", time_multires=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.cpu() - b.cpu()).abs().max()) / max(
        float(b.abs().max()), 1e-12)


def _rows_close(got, want):
    """Within 1e-5 on all but 1% of rows and within 1e-2 on those, of the
    largest |want| (a bf16 rounding the MLP flips moves a row by ~2^-8)."""
    want = want.cpu().reshape(want.shape[0], -1)
    off = (got.cpu().reshape(want.shape) - want).abs().amax(-1) / max(
        float(want.abs().max()), 1e-12)
    frac = float((off > 1e-5).float().mean())
    assert frac <= 1e-2 and float(off.max()) <= 1e-2, (frac, float(off.max()))


def _points(n, seed, bound=0.9):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((n, 3), generator=g) * 2 - 1) * bound
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return x, d


@pytest.mark.cuda
def test_dnerf_field_through_k1_matches_cpu(cuda_device):
    """The full-width deform field (5x128 deform net, 16 levels F=2 at
    T=2^15 'wrap') with a non-zero warp, on 2^16 points at per-point times:
    one K1 launch a density call; the warp, sigma and colour row by row
    (`_rows_close`: the deform MLP's bf16 roundings flip on a few rows)."""
    cfg = dnerf.DNeRFConfig(**O_FIELD)
    params = dnerf.init(cfg, generator=torch.Generator().manual_seed(0))
    params["deform_net"][-1]["w"] = 0.05 * torch.randn(
        params["deform_net"][-1]["w"].shape,
        generator=torch.Generator().manual_seed(1))
    x, d = _points(2**16, 2)
    t = torch.rand(2**16, generator=torch.Generator().manual_seed(3))
    gp = map_tree(params, lambda _, v: v.to(cuda_device))
    before = halo_encode.launches
    with torch.no_grad():
        s_g, c_g, w_g = dnerf.apply(gp, cfg, x.to(cuda_device),
                                    d.to(cuda_device), t.to(cuda_device))
        s_c, c_c, w_c = dnerf.apply(params, cfg, x, d, t)
    assert halo_encode.launches == before + 1
    _rows_close(w_g, w_c)
    _rows_close(s_g, s_c)
    _rows_close(c_g, c_c)


@pytest.mark.cuda
def test_dnerf_train_step_matches_cpu(cuda_device):
    """One -O train step (halo, deform_reg and sigma_reg on) on the same
    rays, jitter, regularizer points and time grid, on both devices: the
    loss within 1e-4, every gradient within 1e-2 of its leaf's largest
    entry, the deform net's from the L1 term alone."""
    ds = DynamicSyntheticScene().make_dataset(n_views=4, h=64, w=64, seed=0)
    cfg = dnerf.DNeRFConfig(**O_FIELD)
    grads = {}
    for dev in (torch.device("cpu"), cuda_device):
        tr = DNeRFTrainer(cfg, RenderOptions(**OPTS),
                          TrainConfig(num_rays=1024, max_steps=100),
                          dataset=ds, device=dev, time_size=8,
                          deform_reg=1e-3, sigma_reg=1e-3)
        tr.init_state()
        g = torch.Generator().manual_seed(5)
        kw = dict(uni_codes=torch.randint(0, 2**21, (8, 1, 2**15),
                                          generator=g),
                  uniforms=torch.rand((8, 1, 2**15), generator=g),
                  jitter=torch.rand((8, 1, 2**16, 3), generator=g),
                  time_jitter=torch.rand((8, 1, 2**16), generator=g))
        tr.slices_per_update = 8
        with torch.no_grad():
            tr.state = tr.state._replace(occ=occupancy_t_update(
                tr.state.occ, lambda xx, tt: dnerf.density(
                    tr.state.params, cfg, xx, tt)["sigma"], 1.0, range(8),
                cells_per_slice=2**15,
                **{k: v.to(dev) for k, v in kw.items()}))
        rand = StepRandom(
            img_idx=torch.tensor(1, device=dev),
            inds=torch.randint(0, 64 * 64, (1024,), generator=g).to(dev),
            bg=None, jitter=torch.rand((1024,), generator=g).to(dev),
            reg_points=(torch.rand((4096, 3), generator=g) * 2 - 1).to(dev))
        batch = tr.sample_batch(rand)
        bits = tr.state.occ.bitfield[tr.time_slice(batch["time"])]
        loss, gr, _ = tr._value_and_grads(
            tr.state.params, lambda p: tr.loss_fn(p, bits, batch, rand.jitter))
        grads[dev.type] = (float(loss), dict(flatten_tree(gr)))
    (lc, gc), (lg, gg) = grads["cpu"], grads["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k, v in gc.items():
        if float(v.abs().max()) > 0:
            assert _rel(gg[k], v) <= 1e-2, k
    assert float(gc["deform_net/4/w"].abs().max()) > 0


@pytest.mark.cuda
def test_time_grid_update_matches_cpu(cuda_device):
    g = torch.Generator().manual_seed(7)
    kw = dict(uni_codes=torch.randint(0, 2**21, (3, 1, 2**16), generator=g),
              uniforms=torch.rand((3, 1, 2**16), generator=g),
              jitter=torch.rand((3, 1, 2**17, 3), generator=g),
              time_jitter=torch.rand((3, 1, 2**17), generator=g))
    scene = DynamicSyntheticScene()
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        st = occupancy_t_init(4, 1, device=dev)
        for _ in range(2):
            st = occupancy_t_update(st, scene.density_t, 1.0, [3, 0, 1],
                                    cells_per_slice=2**16,
                                    **{k: v.to(dev) for k, v in kw.items()})
        out.append(st)
    cpu, card = out
    np.testing.assert_allclose(card.density_grid.cpu().numpy(),
                               cpu.density_grid.numpy(), rtol=1e-4, atol=1e-4)
    bits_c = np.unpackbits(cpu.bitfield.numpy())
    bits_g = np.unpackbits(card.bitfield.cpu().numpy())
    assert (bits_c != bits_g).mean() <= 1e-3 and bits_c.any()


@pytest.mark.cuda
def test_bucket_positions_gradient_on_the_card(cuda_device):
    """The `bucket` encode's dx (plain ops beside K2) on the card against the
    CPU at T=2^19, 16 levels, F=2; the fused 'pallas' encode gives none."""
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=19,
                         backend="bucket")
    g = torch.Generator().manual_seed(8)
    tab = torch.rand((cfg.total_params, 2), generator=g) - 0.5
    x = torch.rand((2**14, 3), generator=g)
    cot = torch.randn((2**14, 32), generator=g)
    dx_c = bucket_dx(cot, tab, x, cfg)
    xg = x.to(cuda_device).requires_grad_()
    (hash_encode(tab.to(cuda_device), xg, cfg).reshape(2**14, -1)
     * cot.to(cuda_device)).sum().backward()
    assert _rel(xg.grad, dx_c) <= 1e-5
    pal = HashGridConfig(num_levels=16, log2_hashmap_size=15,
                         backend="pallas")
    xp = x.to(cuda_device).requires_grad_()
    tp = (torch.rand((pal.total_params, 2), generator=g) - 0.5).to(cuda_device)
    hash_encode(tp.requires_grad_(), xp, pal).sum().backward()
    assert xp.grad is None and tp.grad is not None


@pytest.mark.cuda
def test_ccnerf_and_sdf_fields_match_cpu(cuda_device):
    cc = ccnerf.CCNeRFConfig()
    params = ccnerf.init(cc, generator=torch.Generator().manual_seed(0))
    x, d = _points(2**15, 9)
    gp = map_tree(params, lambda _, v: v.to(cuda_device))
    with torch.no_grad():
        s_g, c_g = ccnerf.apply_residual(gp, cc, x.to(cuda_device),
                                         d.to(cuda_device))
        s_c, c_c = ccnerf.apply_residual(params, cc, x, d)
    assert _rel(s_g, s_c) <= 1e-5
    assert _rel(c_g, c_c) <= 1e-5
    cfg = sdf.SDFConfig()
    sp = sdf.init(cfg, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y_g = sdf.apply(map_tree(sp, lambda _, v: v.to(cuda_device)), cfg,
                        x.to(cuda_device))
        y_c = sdf.apply(sp, cfg, x)
    _rows_close(y_g, y_c)
    verts, faces = box_mesh_from_aabb(np.array([[-1, -1, -1], [1, 1, 1.0]]))
    ds_c = SDFDataset(verts=verts, faces=faces, scale=0.6, seed=2,
                      device="cpu")
    ds_g = SDFDataset(verts=verts, faces=faces, scale=0.6, seed=2,
                      device=cuda_device)
    (p_c, l_c), (p_g, l_g) = ds_c.batch(16384), ds_g.batch(16384)
    assert torch.equal(p_g.cpu(), p_c)
    assert float((l_g.cpu() - l_c).abs().max()) <= 1e-6
