"""The last helpers of the JAX package in the port, each against the JAX
function on the same inputs: `HardSyntheticScene` (density, colour and a
rendered view at a small size: 1e-4, the uint8 images within one level),
`hashgrid_tv_loss` (value 1e-6 relative and gradient, as tests/test_ops.py
holds the JAX one), `param_lr_scales`, the `PerceptualMeter` without
weights (the proxy, named `lpips_proxy`; LPIPS needs a local weights file,
and an `LPIPSMeter` without one is unavailable) and `visualize_poses`
(writes its PNG)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.synthetic import HardSyntheticScene as JHard
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops.hashgrid import HashGridConfig as JGrid
from seal3d_tpu.ops.hashgrid import hashgrid_tv_loss as j_tv
from seal3d_tpu.train.metrics import lpips_proxy as j_proxy
from seal3d_tpu_torch.data.provider import rand_poses, visualize_poses
from seal3d_tpu_torch.data.synthetic import HardSyntheticScene as THard
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from seal3d_tpu_torch.ops.hashgrid import hashgrid_tv_loss as t_tv
from seal3d_tpu_torch.train.metrics import LPIPSMeter, PerceptualMeter


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_hard_scene_fields_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    j, t = JHard(), THard()
    np.testing.assert_allclose(t.density(torch.from_numpy(x)).numpy(),
                               np.asarray(j.density(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        t.color(torch.from_numpy(x), torch.from_numpy(d)).numpy(),
        np.asarray(j.color(jnp.asarray(x), jnp.asarray(d))), atol=1e-5)
    assert t.gt_steps == j.gt_steps == 768
    assert t.density_scale == j.density_scale == 90.0


def test_hard_scene_views_match_jax():
    jds = JHard().make_dataset(n_views=2, h=16, w=16, seed=3)
    tds = THard().make_dataset(n_views=2, h=16, w=16, seed=3)
    np.testing.assert_array_equal(tds.poses, jds.poses)
    diff = np.abs(tds.images.astype(int) - jds.images.astype(int))
    assert diff.max() <= 1
    assert tds.images.std() > 10     # the scene is in view


def test_hashgrid_tv_loss_matches_jax():
    kw = dict(num_levels=2, level_dim=1, base_resolution=4,
              desired_resolution=8, log2_hashmap_size=16)
    tcfg, jcfg = TGrid(**kw), JGrid(**kw)
    assert float(t_tv(torch.zeros((tcfg.total_params, 1)), tcfg)) == 0.0
    rough = np.random.default_rng(1).uniform(
        -1, 1, (tcfg.total_params, 1)).astype(np.float32)
    t = torch.from_numpy(rough).requires_grad_()
    v = t_tv(t, tcfg, level=0)
    v.backward()
    ref = float(j_tv(jnp.asarray(rough), jcfg, level=0))
    assert float(v.detach()) > 0.0
    np.testing.assert_allclose(float(v.detach()), ref, rtol=1e-6)
    g = jax.grad(lambda tb: j_tv(tb, jcfg))(jnp.asarray(rough))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-7)
    hashed = TGrid(num_levels=2, log2_hashmap_size=4)
    with pytest.raises(ValueError, match="dense"):
        t_tv(torch.zeros((hashed.total_params, 2)), hashed, level=1)


def test_param_lr_scales_match_jax():
    jcfg = jngp.NGPConfig(log2_hashmap_size=10, num_levels=2, bg_radius=1.0)
    jp = jngp.init(jax.random.PRNGKey(0), jcfg)
    tp = tngp.init(tngp.NGPConfig(log2_hashmap_size=10, num_levels=2,
                                  bg_radius=1.0))
    jscales = jax.tree.leaves(jngp.param_lr_scales(jp, 0.5, 2.0))
    tscales = tngp.param_lr_scales(tp, 0.5, 2.0)
    tleaves = []

    def walk(t):   # jax.tree.leaves' order: dict keys sorted
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            tleaves.append(t)

    walk(tscales)
    assert tleaves == jscales
    assert tscales["encoder"] == 0.5 and tscales["encoder_bg"] == 0.5
    assert tscales["sigma_net"][0]["w"] == 2.0


def test_perceptual_meter_without_weights():
    rng = np.random.default_rng(2)
    a = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    meter = PerceptualMeter()
    assert meter.kind == "lpips_proxy"
    meter.update(a, b)
    meter.update(a, a)
    np.testing.assert_allclose(meter.measure(), j_proxy(a, b) / 2,
                               rtol=1e-6)
    assert meter.report().startswith("lpips_proxy = ")
    gated = LPIPSMeter(weights_path=None)
    assert not gated.available and gated.measure() is None
    # a path that holds no weights leaves the meter on the proxy
    assert PerceptualMeter("/nonexistent/alex.pth").kind == "lpips_proxy"


def test_visualize_poses_writes_png(tmp_path):
    poses = rand_poses(np.random.default_rng(0), 4, radius=2.0)
    out = visualize_poses(poses, out_path=str(tmp_path / "poses.png"))
    assert out == str(tmp_path / "poses.png")
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 1000
