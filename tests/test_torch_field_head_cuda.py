"""The NGP field head's kernel pair on the card (csrc/field_head.cu) against
the plain composition it replaces (ops/field_head.py `field_head_plain`), at
the published widths: forward, the stacked encode's cotangent, one real
Seal-3D pretraining step, and the launch counters on the paths that take
the kernel and on one that does not.

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_field_head_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode).

Tolerances. The kernel sums its bf16 products on the tensor cores and the
plain path in cuBLAS's fp32 GEMMs: same products, another summation order,
so a pre-activation differs by a few fp32 ulps. Where such a value sits that
close to a bf16 rounding boundary, its cast rounds the other way (a "flip":
one bf16 ulp, 2^-8 relative, in a hidden activation or an encode cotangent)
and the row's outputs move by up to ~1e-3 of their scale. So: every element
within FEW_ULPS fp32 ulps of the plain path (relative to the tensor's scale),
except on at most FLIP_SHARE of the rows, which stay within FLIP_TOL
(measured on the H100 at 2^19 rows: at most 0.09% of the rows, and 6.2e-3
of the scale on the encode's cotangent, 5.0e-4 on sigma, 1.7e-4 on rgb).
"""

import math

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.models import ngp
from seal3d_tpu_torch.models.mlp import mlp_init
from seal3d_tpu_torch.ops import field_head as fh

M = 2**16 + 37          # a ragged tail: not a multiple of the 16-row tile
FEW_ULPS = 8 * 2.0**-23  # of the tensor's largest value
FLIP_SHARE = 0.02        # rows with a bf16 flip somewhere in their chain
FLIP_TOL = 2e-2          # of the tensor's largest value, on those rows
BBOX = {"type": "bbox",
        "raw": [[0.15, -0.1, -0.2], [0.55, -0.1, -0.2], [0.15, 0.3, -0.2],
                [0.15, -0.1, 0.2], [0.55, 0.3, -0.2], [0.55, -0.1, 0.2],
                [0.15, 0.3, 0.2], [0.55, 0.3, 0.2]],
        "transform": [[1, 0, 0, 0], [0, 1, 0, 0.35], [0, 0, 1, 0],
                      [0, 0, 0, 1]],
        "scale": [1, 1, 1]}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the field-head kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _nets(dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    sigma_net = mlp_init([32, 64, 16], generator=gen)
    color_net = mlp_init([63, 64, 64, 3], generator=gen)
    to = lambda net: [{"w": l["w"].to(dev)} for l in net]  # noqa: E731
    return to(sigma_net), to(color_net)


def _inputs(dev, m=M, seed=1):
    rng = np.random.default_rng(seed)
    enc = torch.from_numpy(rng.uniform(-1, 1, (m, 16, 4)).astype(np.float32))
    d = rng.normal(size=(m, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                         .astype(np.float32))
    return enc.to(dev), d.to(dev)


def _close(got, want, name):
    """FEW_ULPS everywhere but on at most FLIP_SHARE of the rows, which
    stay within FLIP_TOL; -> the share of such rows."""
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    scale = float(want.abs().max())
    err = (got - want).abs().reshape(want.shape[0], -1).amax(1) / scale
    flips = float((err > FEW_ULPS).float().mean())
    assert flips <= FLIP_SHARE, (name, flips)
    assert float(err.max()) <= FLIP_TOL, (name, float(err.max()))
    return flips


@pytest.mark.cuda
def test_forward_matches_plain(cuda_device):
    sigma_net, color_net = _nets(cuda_device)
    enc, d = _inputs(cuda_device)
    assert fh.kernel_takes(enc, d, sigma_net, color_net, 4)
    n = fh.field_head_fwd.launches
    with torch.no_grad():
        sigma, rgb = fh.field_head(enc, d, sigma_net, color_net, 4)
        ps, pr = fh.field_head_plain(enc, d, sigma_net, color_net, 4)
    torch.cuda.synchronize()
    assert fh.field_head_fwd.launches == n + 1
    _close(sigma, ps, "sigma")
    _close(rgb, pr, "rgb")


@pytest.mark.cuda
def test_backward_matches_plain(cuda_device):
    sigma_net, color_net = _nets(cuda_device, seed=2)
    enc, d = _inputs(cuda_device, seed=3)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    gs = torch.randn(M, device=cuda_device, generator=gen)
    gr = torch.randn(M, 3, device=cuda_device, generator=gen)
    grads = []
    for head in (fh.field_head, fh.field_head_plain):
        x = enc.clone().requires_grad_(True)
        sigma, rgb = head(x, d, sigma_net, color_net, 4)
        (g,) = torch.autograd.grad([sigma, rgb], [x], [gs, gr])
        grads.append(g)
    torch.cuda.synchronize()
    # both paths round the encode's cotangent to bf16
    assert torch.equal(grads[0], grads[0].bfloat16().float())
    _close(grads[0], grads[1], "encode cotangent")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 15, 16, 17, 4097])
def test_small_and_ragged_batches(cuda_device, m):
    sigma_net, color_net = _nets(cuda_device)
    enc, d = _inputs(cuda_device, m=m, seed=m)
    x = enc.clone().requires_grad_(True)
    sigma, rgb = fh.field_head(x, d, sigma_net, color_net, 4)
    (g,) = torch.autograd.grad(sigma.sum() + rgb.sum(), [x])
    y = enc.clone().requires_grad_(True)
    ps, pr = fh.field_head_plain(y, d, sigma_net, color_net, 4)
    (pg,) = torch.autograd.grad(ps.sum() + pr.sum(), [y])
    for got, want in ((sigma, ps), (rgb, pr), (g, pg)):
        got, want = got.detach(), want.detach()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= FLIP_TOL * scale


def _seal_trainer(dev):
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.seal.mappers import build_mapper
    from seal3d_tpu_torch.seal.trainer import PretrainConfig, SealTrainer
    from seal3d_tpu_torch.train.trainer import TrainConfig

    fcfg = ngp.NGPConfig(grid_backend="bucket")
    gen = torch.Generator(device=dev).manual_seed(5)
    teacher = ngp.init(fcfg, generator=gen, device=dev)
    for k in ("encoder", "encoder_color"):   # a teacher with structure
        teacher[k] = torch.rand(teacher[k].shape, generator=gen,
                                device=dev) * 2 - 1
    opts = RenderOptions(bound=1.0, dt_gamma=0.0, min_near=0.05,
                         max_steps=512)
    st = SealTrainer(ngp, fcfg, opts, TrainConfig(num_rays=4096),
                     build_mapper(BBOX), teacher_params=teacher,
                     teacher_bitfield=torch.zeros(128**3 // 8,
                                                  dtype=torch.uint8),
                     seed=0, device=dev)
    st.init_state()
    st.init_pretraining(PretrainConfig(batch_size=2**17,
                                       local_point_step=0.02,
                                       surrounding_point_step=0.04,
                                       global_point_step=0.1))
    return st


def _loss_and_grads(st, batch):
    params = dict(st.state.params)
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in ("encoder", "encoder_color")}
    loss = st.pretrain_loss({**params, **leaves}, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss), grads


@pytest.mark.cuda
def test_seal_pretrain_step_matches_plain(cuda_device, monkeypatch):
    st = _seal_trainer(cuda_device)
    src = st.pretrain_data["local"]
    batch = {k: src[k][0] for k in ("points", "dirs", "sigma", "color",
                                    "weight")}
    n = (fh.field_head_fwd.launches, fh.field_head_bwd.launches)
    loss, grads = _loss_and_grads(st, batch)
    assert (fh.field_head_fwd.launches, fh.field_head_bwd.launches) == (
        n[0] + 1, n[1] + 1)
    monkeypatch.setattr(fh, "kernel_takes", lambda *a: False)
    p_loss, p_grads = _loss_and_grads(st, batch)
    assert abs(loss - p_loss) <= 1e-5 * abs(p_loss)
    for g, p in zip(grads, p_grads):
        # the tables' gradients, summed by K2's atomics in either case
        gap = abs(float(g.norm()) - float(p.norm())) / float(p.norm())
        assert gap <= 1e-4, gap
        assert float((g - p).abs().max()) <= 1e-2 * float(p.abs().max())


@pytest.mark.cuda
def test_launches_on_the_local_stage_and_not_in_training(cuda_device):
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.train.trainer import TrainConfig, Trainer

    st = _seal_trainer(cuda_device)
    n = (fh.field_head_fwd.launches, fh.field_head_bwd.launches)
    losses = st.pretrain_epochs(1)
    batches = sum(v["n_batches"] for v in st.pretrain_data.values())
    assert np.isfinite(losses).all()
    assert (fh.field_head_fwd.launches - n[0],
            fh.field_head_bwd.launches - n[1]) == (batches, batches)

    # NGP training moves the MLPs: the plain path, no launch
    ds = SyntheticScene().make_dataset(n_views=2, h=32, w=32, seed=0)
    tr = Trainer(ngp, ngp.NGPConfig(grid_backend="bucket"),
                 RenderOptions(bound=1.0, dt_gamma=0.0, min_near=0.05,
                               max_steps=512),
                 TrainConfig(num_rays=1024), dataset=ds, device=cuda_device)
    tr.init_state()
    n = (fh.field_head_fwd.launches, fh.field_head_bwd.launches)
    loss = float(tr.train_step()["loss"])
    assert math.isfinite(loss)
    assert (fh.field_head_fwd.launches, fh.field_head_bwd.launches) == n
