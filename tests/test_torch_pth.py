"""Reference `.pth` interop of the port (`export_torch_ngp` /
`import_torch_ngp`) against the JAX package's functions of the same names,
across the padded ('pallas') and native ('xla', 'bucket') level layouts;
mirrors tests/test_checkpoint.py:33-83. The configs put the two dense
levels at 2^14 (17^3 and 24^3 cells), so a padded layout carries padding
rows that the native one truncates and import refills with zeros.

Both directions go through a file: a JAX export imported by the port, and a
port export imported by JAX. MLP weights move bit for bit; tables move bit
for bit in the rows the encode addresses (the native conversion of both
sides is equal), and a converted table encodes like the original (1e-6,
fp32 gathers on both sides).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops import hashgrid as jhg
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu_torch import main_nerf
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.ops import hashgrid as thg
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.checkpoint import flatten_tree, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(backend):
    kw = dict(bound=1.0, log2_hashmap_size=14, grid_backend=backend)
    return jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)


def _native(cfg):
    return dataclasses.replace(cfg, backend="xla")


def _np_tree(params):
    return {k: v.numpy() for k, v in flatten_tree(params)}


def _assert_same_field(got: dict, want: dict, tcfg):
    """MLP leaves equal; tables equal in their native conversion (the rows
    the encode addresses) and encoding 200 points alike."""
    assert set(got) == set(want)
    native = _native(tcfg.grid)
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (200, 3)).astype(np.float32))
    for k in want:
        if k in ("encoder", "encoder_color"):
            a, b = torch.from_numpy(got[k]), torch.from_numpy(want[k])
            np.testing.assert_array_equal(
                thg.convert_table_layout(a, tcfg.grid, native).numpy(),
                thg.convert_table_layout(b, tcfg.grid, native).numpy(),
                err_msg=k)
            np.testing.assert_allclose(
                thg.hashgrid_encode(a, x, tcfg.grid).numpy(),
                thg.hashgrid_encode(b, x, tcfg.grid).numpy(), atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("src,dst", [("pallas", "pallas"), ("pallas", "xla"),
                                     ("xla", "pallas"), ("bucket", "bucket")])
def test_jax_export_imports_into_port(tmp_path, src, dst):
    """A JAX `.pth` (exported from `src` params) loads into a port params
    tree of layout `dst`."""
    jsrc, tsrc = _cfgs(src)
    _, tdst = _cfgs(dst)
    params = jngp.init(jax.random.PRNGKey(0), jsrc)
    path = str(tmp_path / "ref.pth")
    jckpt.export_torch_ngp(path, params, step=5, grid_cfg=jsrc.grid)

    fresh = tngp.init(tdst, generator=torch.Generator().manual_seed(1))
    loaded = _np_tree(tckpt.import_torch_ngp(path, fresh, grid_cfg=tdst.grid))
    want = _np_tree(params_from_jax(jax.tree.map(np.asarray, params)))
    if src != dst:   # re-pack the reference params into the port's layout
        for k in ("encoder", "encoder_color"):
            want[k] = thg.convert_table_layout(
                torch.from_numpy(want[k]), tsrc.grid, tdst.grid).numpy()
    _assert_same_field(loaded, want, tdst)
    if dst != "pallas":   # a native layout arrives untouched
        for k in ("encoder", "encoder_color"):
            np.testing.assert_array_equal(loaded[k], want[k])


@pytest.mark.parametrize("backend", ["pallas", "bucket"])
def test_port_export_imports_into_jax(tmp_path, backend):
    """A port `.pth` loads through the JAX import into a JAX params tree of
    the same layout; the file holds the reference's state-dict names and
    [out, in] weights."""
    jcfg, tcfg = _cfgs(backend)
    params = tngp.init(tcfg, generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "port.pth")
    tckpt.export_torch_ngp(path, params, step=7, grid_cfg=tcfg.grid)
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["global_step"] == 7
    sd = ckpt["model"]
    assert sd["encoder.embeddings"].shape == (_native(tcfg.grid).total_params,
                                              2)
    assert sd["sigma_net.0.weight"].shape == params["sigma_net"][0]["w"].T.shape

    template = jngp.init(jax.random.PRNGKey(4), jcfg)
    loaded = jckpt.import_torch_ngp(path, template, grid_cfg=jcfg.grid)
    got = _np_tree(params_from_jax(jax.tree.map(np.asarray, loaded)))
    _assert_same_field(got, _np_tree(params), tcfg)
    x = jax.random.uniform(jax.random.PRNGKey(2), (64, 3))
    np.testing.assert_allclose(
        np.asarray(jhg.hashgrid_encode(loaded["encoder"], x, jcfg.grid)),
        thg.hashgrid_encode(params["encoder"], torch.from_numpy(np.array(x)),
                            tcfg.grid).numpy(), atol=1e-6)


def test_cli_loads_pth_into_params_only(tmp_path):
    """`--ckpt x.pth` replaces `params` only, as the reference's CLI does:
    the EMA params that renders use keep their init values (a reference
    quirk, ROADMAP Queue 3), and the test views are written."""
    jcfg = jngp.NGPConfig(bound=1.0, log2_hashmap_size=12,
                          grid_backend="bucket")
    params = jngp.init(jax.random.PRNGKey(5), jcfg)
    path = str(tmp_path / "ref.pth")
    jckpt.export_torch_ngp(path, params, step=3, grid_cfg=jcfg.grid)
    ws = str(tmp_path / "ws")
    tr = main_nerf.main(["synthetic", "-O", "--test", "--grid_backend",
                         "bucket", "--device", "cpu", "--bound", "1.0",
                         "--dt_gamma", "0", "--min_near", "0.05",
                         "--max_steps", "512", "--log2_hashmap_size", "12",
                         "--H", "16", "--W", "16", "--ckpt", path,
                         "--workspace", ws])
    want = _np_tree(params_from_jax(jax.tree.map(np.asarray, params)))
    got = _np_tree(tr.state.params)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    init = _np_tree(tngp.init(tr.fcfg,
                              generator=torch.Generator().manual_seed(0)))
    ema = _np_tree(tr.state.ema_params)
    for k in init:
        np.testing.assert_array_equal(ema[k], init[k], err_msg=k)
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 8
