"""The TensoRF field and its train step on the card against the same on the
CPU: `apply` (VM, CP, with the background net) at a full-width config on
2^16 seeded points, and the loss and gradient of one train step of
`TensoRFTrainer` on the same rays, jitter and occupancy, then one whole step
on the card. On the card the VM pairs' lookups run through their kernel
pair (ops/tensorf_vm.py; held against the plain path in
tests/test_torch_tensorf_vm.py), on the CPU through the plain Functions;
CP and the background net take the Functions on both devices.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX: python -m pytest --noconftest -m cuda
tests/test_torch_tensorf_cuda.py

Without a CUDA device the tests skip. Tolerances: sigma and the sigma
factors' gradients within 1e-4 of their largest entry (fp32; the card's
scatters add in another order). The colour MLP rounds its inputs,
activations and, through the casts' backward, its gradients to bf16, so an
fp32 ulp between the devices can flip one rounding: colours within 1e-5 on
all but 1% of rows and within 1e-2 on those; the gradients of the colour
path's leaves (colour factors, basis, MLP) within 1e-2 of their largest
entry (a bf16 ulp is 2^-8).
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.data.synthetic import SyntheticScene
from seal3d_tpu_torch.models import tensorf as ttf
from seal3d_tpu_torch.ops.raymarch import sph_from_ray
from seal3d_tpu_torch.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu_torch.render.renderer import RenderOptions
from seal3d_tpu_torch.train.checkpoint import flatten_tree, map_tree
from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer
from seal3d_tpu_torch.train.trainer import StepRandom, TrainConfig

OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


def _rgb_close(got, want):
    off = (got - want).abs().amax(-1)
    frac = float((off > 1e-5).float().mean())
    assert frac <= 1e-2 and float(off.max()) <= 1e-2, (frac, float(off.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("decomposition,bg", [("vm", False), ("cp", False),
                                              ("vm", True)])
def test_apply_on_the_card_matches_cpu(cuda_device, decomposition, bg):
    cfg = ttf.TensoRFConfig(decomposition=decomposition,
                            bg_radius=4.0 if bg else -1.0)
    params = ttf.init(cfg, generator=torch.Generator().manual_seed(0))
    on_card = map_tree(params, lambda _, t: t.to(cuda_device))
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((2**16, 3), generator=gen) * 2.1 - 1.05
    d = torch.nn.functional.normalize(torch.randn((2**16, 3), generator=gen),
                                      dim=-1)
    with torch.no_grad():
        s_c, c_c = ttf.apply(params, cfg, x, d)
        s_g, c_g = ttf.apply(on_card, cfg, x.to(cuda_device), d.to(cuda_device))
        assert _rel(s_g.cpu(), s_c) <= 1e-4, _rel(s_g.cpu(), s_c)
        _rgb_close(c_g.cpu(), c_c)
        if bg:
            o = torch.rand((2**16, 3), generator=gen) - 0.5
            sph = sph_from_ray(o, d, cfg.bg_radius)
            sph_g = sph_from_ray(o.to(cuda_device), d.to(cuda_device),
                                 cfg.bg_radius)
            assert float((sph_g.cpu() - sph).abs().max()) <= 1e-5
            _rgb_close(ttf.background(on_card, cfg, sph_g,
                                      d.to(cuda_device)).cpu(),
                       ttf.background(params, cfg, sph, d))


def _trainer(device):
    ds = SyntheticScene().make_dataset(n_views=4, h=64, w=64, seed=0)
    tr = TensoRFTrainer(ttf.TensoRFConfig(), RenderOptions(**OPTS),
                        TrainConfig(num_rays=4096, max_steps=100),
                        dataset=ds, device=device, upsample_steps=(),
                        shrink_step=None)
    tr.init_state()
    occ = occupancy_update(occupancy_init(1, device=device),
                           SyntheticScene().density, 1.0, density_thresh=0.01,
                           generator=torch.Generator(device).manual_seed(2))
    tr.state = tr.state._replace(occ=occ)
    return tr


@pytest.mark.cuda
def test_train_step_on_the_card_matches_cpu(cuda_device):
    cpu, card = _trainer("cpu"), _trainer(cuda_device)
    # the same params, occupancy and random numbers on both devices
    card.state = card.state._replace(
        params=map_tree(cpu.state.params, lambda _, t: t.to(cuda_device)),
        occ=type(cpu.state.occ)(*[t.to(cuda_device) for t in cpu.state.occ]))
    gen = torch.Generator().manual_seed(3)
    rand = StepRandom(img_idx=torch.tensor(1),
                      inds=torch.randint(0, 64 * 64, (4096,), generator=gen),
                      bg=torch.rand((4096, 3), generator=gen),
                      jitter=torch.rand((4096,), generator=gen))
    on_card = StepRandom(*[None if t is None else t.to(cuda_device)
                           for t in rand])
    outs = []
    for tr, r in ((cpu, rand), (card, on_card)):
        batch = tr.sample_batch(r)
        outs.append(tr.loss_and_grads(tr.state.params, tr.state.occ, batch,
                                      r.jitter))
    (l_c, g_c, o_c), (l_g, g_g, o_g) = outs
    assert int(o_g["num_samples"]) == int(o_c["num_samples"]) > 0
    assert abs(float(l_g) - float(l_c)) <= 1e-4 * abs(float(l_c))
    grads = dict(flatten_tree(g_c))
    errs = {k: _rel(v.cpu(), grads[k]) for k, v in flatten_tree(g_g)}
    print(f"\n[tensorf cuda] gradient error relative to the largest entry: "
          f"{errs}")
    for k, err in errs.items():
        assert err <= (1e-4 if k.startswith("sigma_") else 1e-2), (k, err)

    before = map_tree(card.state.params, lambda _, t: t.clone())
    metrics = card.train_step(on_card)
    assert np.isfinite(float(metrics["loss"]))
    assert torch.equal(card.state.params["aabb"], before["aabb"])
    assert not torch.equal(card.state.params["sigma_mat"][0],
                           before["sigma_mat"][0])
