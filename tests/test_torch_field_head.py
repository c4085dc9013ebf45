"""The NGP field head on the CPU (ops/field_head.py): `ngp.apply` and its
gradients equal, bit for bit, the composition it ran before the field head
had a kernel (the split of the stacked encode, the two MLPs, SH, trunc_exp
and the sigmoid as separate ops); the rule that sends a call to the kernel
or to that composition; and the module's import on a machine without nvcc.
The kernel itself runs only on the card (tests/test_torch_field_head_cuda.py).
"""

import os
import subprocess
import sys

import pytest
import torch

from seal3d_tpu_torch.models import ngp
from seal3d_tpu_torch.models.mlp import mlp_apply, mlp_init
from seal3d_tpu_torch.ops import field_head as fh
from seal3d_tpu_torch.ops.hashgrid import (hashgrid_encode,
                                           hashgrid_encode_stacked,
                                           split_stacked)
from seal3d_tpu_torch.ops.sh import sh_encode
from seal3d_tpu_torch.ops.trunc_exp import trunc_exp

GRIDS = {"xla": dict(log2_hashmap_size=12),
         "bucket": dict(log2_hashmap_size=12, grid_backend="bucket"),
         "halo": dict(log2_hashmap_size=12, grid_backend="halo",
                      gridtype="wrap")}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the CPU scatter of the tables' gradients sums
    in the order its threads finish, so two runs of the same ops agree bit
    for bit only on one thread (and the suite's workers do not
    oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _before(params, cfg, x, d, valid=None):
    """ngp.apply as it was composed before the field head's kernel."""
    widths = [params["encoder"].shape[-1], params["encoder_color"].shape[-1]]
    out = hashgrid_encode(torch.cat([params["encoder"],
                                     params["encoder_color"]], dim=-1),
                          (x + cfg.bound) / (2.0 * cfg.bound), cfg.grid,
                          valid=valid)
    out = out.reshape(*out.shape[:-1], cfg.num_levels, sum(widths))
    parts, start = [], 0
    for f in widths:
        part = out[..., start:start + f]
        parts.append(part.reshape(*part.shape[:-2], cfg.num_levels * f))
        start += f
    feat, c_enc = parts
    h = mlp_apply(params["sigma_net"], feat)
    sigma = trunc_exp(h[..., 0])
    hc = torch.cat([sh_encode(d, cfg.sh_degree), h[..., 1:], c_enc], dim=-1)
    return sigma, torch.sigmoid(mlp_apply(params["color_net"], hc))


def _case(backend, seed=0, m=301):
    cfg = ngp.NGPConfig(**GRIDS[backend])
    gen = torch.Generator().manual_seed(seed)
    params = ngp.init(cfg, generator=gen)
    for k in ("encoder", "encoder_color"):
        params[k] = torch.rand(params[k].shape, generator=gen) * 2 - 1
    x = torch.rand((m, 3), generator=gen) * 2 - 1
    d = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen),
                                      dim=-1)
    valid = torch.rand((m,), generator=gen) > 0.2
    return cfg, params, x, d, valid


@pytest.mark.parametrize("backend", sorted(GRIDS))
@pytest.mark.parametrize("train_mlps", [False, True])
def test_apply_equals_the_composition_before(backend, train_mlps):
    cfg, params, x, d, valid = _case(backend)
    names = ["encoder", "encoder_color"] + (
        ["sigma_net", "color_net"] if train_mlps else [])
    gen = torch.Generator().manual_seed(9)
    gs = torch.randn((x.shape[0],), generator=gen)
    gr = torch.randn((x.shape[0], 3), generator=gen)
    results = []
    for fn in (ngp.apply, _before):
        p = {k: (v.clone().requires_grad_(True) if k == "encoder"
                 or k == "encoder_color" else
                 [{"w": l["w"].clone().requires_grad_(train_mlps)}
                  for l in v]) for k, v in params.items()}
        sigma, rgb = fn(p, cfg, x, d, valid=valid)
        leaves = [p["encoder"], p["encoder_color"]] + (
            [l["w"] for k in names[2:] for l in p[k]])
        grads = torch.autograd.grad([sigma, rgb], leaves, [gs, gr])
        results.append((sigma, rgb, *grads))
    for got, want in zip(*results):
        assert torch.equal(got, want)


def test_apply_keeps_batch_shapes():
    cfg, params, x, d, valid = _case("xla", m=96)
    sigma, rgb = ngp.apply(params, cfg, x.reshape(4, 24, 3),
                           d.reshape(4, 24, 3))
    want_s, want_r = _before(params, cfg, x, d)
    assert sigma.shape == (4, 24) and rgb.shape == (4, 24, 3)
    assert torch.equal(sigma.reshape(-1), want_s)
    assert torch.equal(rgb.reshape(-1, 3), want_r)


def test_stacked_encode_splits_into_each_tables_encode():
    cfg, params, x, _, _ = _case("xla")
    xf = (x + 1.0) / 2.0
    enc = hashgrid_encode_stacked((params["encoder"],
                                   params["encoder_color"]), xf, cfg.grid)
    assert enc.shape == (x.shape[0], 16, 4)
    for part, k in zip(split_stacked(enc, (2, 2)),
                       ("encoder", "encoder_color")):
        # the widened gather sums its corners in another vector order
        torch.testing.assert_close(part,
                                   hashgrid_encode(params[k], xf, cfg.grid),
                                   rtol=0, atol=1e-6)


def _nets(sigma_dims=(32, 64, 16), color_dims=(63, 64, 64, 3)):
    gen = torch.Generator().manual_seed(1)
    return mlp_init(sigma_dims, generator=gen), mlp_init(color_dims,
                                                         generator=gen)


def _head_inputs(m=8, levels=16):
    return torch.zeros((m, levels, 4)), torch.zeros((m, 3))


def test_rule_takes_the_published_widths():
    sigma_net, color_net = _nets()
    enc, d = _head_inputs()
    assert fh._fits(enc, d, sigma_net, color_net, 4)
    # CPU tensors take the plain composition whatever they fit
    assert not fh.kernel_takes(enc, d, sigma_net, color_net, 4)


@pytest.mark.parametrize("net", ["sigma_net", "color_net"])
def test_rule_sends_trained_mlps_to_the_plain_path(net):
    nets = dict(zip(("sigma_net", "color_net"), _nets()))
    nets[net][-1]["w"].requires_grad_(True)
    enc, d = _head_inputs()
    assert not fh._fits(enc, d, nets["sigma_net"], nets["color_net"], 4)
    with torch.no_grad():   # a render of a field in training: no gradient
        assert fh._fits(enc, d, nets["sigma_net"], nets["color_net"], 4)


def test_rule_sends_a_direction_gradient_to_the_plain_path():
    sigma_net, color_net = _nets()
    enc, d = _head_inputs()
    assert not fh._fits(enc, d.requires_grad_(True), sigma_net, color_net,
                        4)
    # the encode's own gradient is the kernel's
    assert fh._fits(enc.requires_grad_(True), d.detach(), sigma_net,
                    color_net, 4)


@pytest.mark.parametrize("case", ["hidden 32", "colour hidden 32",
                                  "geo_feat 7", "8 levels", "sh degree 3",
                                  "float64"])
def test_rule_sends_other_widths_to_the_plain_path(case):
    sigma_dims, color_dims = [32, 64, 16], [63, 64, 64, 3]
    levels, sh = 16, 4
    if case == "hidden 32":
        sigma_dims[1] = 32
    elif case == "colour hidden 32":
        color_dims[1:3] = [32, 32]
    elif case == "geo_feat 7":
        sigma_dims[2], color_dims[0] = 8, 55
    elif case == "8 levels":
        levels, sigma_dims[0], color_dims[0] = 8, 16, 47
    elif case == "sh degree 3":
        sh, color_dims[0] = 3, 56
    sigma_net, color_net = _nets(sigma_dims, color_dims)
    enc, d = _head_inputs(levels=levels)
    if case == "float64":
        enc = enc.double()
    assert not fh._fits(enc, d, sigma_net, color_net, sh)


def test_imports_without_nvcc(tmp_path):
    code = ("import shutil\n"
            "import seal3d_tpu_torch.models.ngp\n"
            "import seal3d_tpu_torch.ops.field_head as fh\n"
            "from seal3d_tpu_torch.runtime import build\n"
            "assert shutil.which('nvcc') is None\n"
            "assert build.load_library.cache_info().currsize == 0\n"
            "assert fh._entry.cache_info().currsize == 0\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
