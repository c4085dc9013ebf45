"""Port parity of SDF fitting against the JAX package: the mesh loader, the
dataset's points and signed-distance labels from one seed, the field, the
optimizer (optax.adam), 100 steps side by side and the `main_sdf` CLI with
a mesh on the CPU.

Tolerances: the points are bit-identical (both draw them with numpy); the
labels within 1e-6 (the point-triangle distance in fp32 in both); the field
rtol 1e-4 / atol 1e-6 (bf16-rounded MLP operands in both, fp32 sums); Adam
1e-6 relative over 3 updates; the fit's MAE within 5% of the reference's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seal3d_tpu.data.sdf_provider import SDFDataset as JDataset
from seal3d_tpu.data.sdf_provider import load_mesh as j_load_mesh
from seal3d_tpu.models import sdf as jsdf
from seal3d_tpu.seal.geometry import box_mesh_from_aabb
from seal3d_tpu.train.sdf_trainer import SDFTrainer as JTrainer
from seal3d_tpu_torch import main_sdf
from seal3d_tpu_torch.data import sdf_provider
from seal3d_tpu_torch.data.sdf_provider import SDFDataset as TDataset
from seal3d_tpu_torch.data.sdf_provider import load_mesh as t_load_mesh
from seal3d_tpu_torch.models import sdf as tsdf
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates
from seal3d_tpu_torch.train.sdf_trainer import SDFTrainer as TTrainer
from seal3d_tpu_torch.utils.losses import mape_loss


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEPS, POINTS, LOG2T = 100, 2048, 14
MAE_RTOL = 0.05


def _box():
    return box_mesh_from_aabb(np.array([[-1, -1, -1], [1, 1, 1.0]]))


def _datasets(seed=0, scale=0.5):
    verts, faces = _box()
    return (JDataset(verts=verts, faces=faces, scale=scale, seed=seed),
            TDataset(verts=verts, faces=faces, scale=scale, seed=seed,
                     device="cpu"))


def _write_meshes(tmp_path):
    """A tetrahedron-capped box as ascii OBJ (with v/vt/vn faces) and PLY."""
    verts, faces = _box()
    verts = np.concatenate([verts, [[0.0, 0.0, 2.0]]]).astype(np.float32)
    obj = str(tmp_path / "m.obj")
    with open(obj, "w") as f:
        f.write("# a comment\n\n")
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1}/1/1 {b + 1}/2/2 {c + 1}/3/3\n")
    ply = str(tmp_path / "m.ply")
    from seal3d_tpu_torch.runtime.mesh_export import save_mesh

    save_mesh(ply, verts, faces)
    return obj, ply, verts, faces


def test_load_mesh_matches_jax(tmp_path):
    obj, ply, verts, faces = _write_meshes(tmp_path)
    for path in (obj, ply):
        tv, tf = t_load_mesh(path)
        jv, jf = j_load_mesh(path)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tf, faces)
        np.testing.assert_allclose(tv, verts)


def test_dataset_batches_match_jax(monkeypatch):
    jds, tds = _datasets(seed=3)
    np.testing.assert_array_equal(tds.verts, jds.verts)
    for n in (1000, 257):
        jp, js = jds.batch(n)
        tp, ts = tds.batch(n)
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-6)
    # signs: deep inside, outside, near the surface (tests/test_sdf.py)
    pts = torch.tensor([[0.0, 0, 0], [0.9, 0.9, 0.9], [0.45, 0, 0]])
    s = tds.sdf(pts).numpy()
    assert s[0] < -0.4 and s[1] > 0.3 and abs(s[2]) < 0.07
    # a chunked label call gives the same numbers
    monkeypatch.setattr(sdf_provider, "CHUNK_PAIRS", 12 * 7)
    small = TDataset(verts=_box()[0], faces=_box()[1], scale=0.5,
                     device="cpu")
    assert small.chunk == 7
    np.testing.assert_array_equal(small.sdf(tp).numpy(), ts.numpy())


@pytest.mark.parametrize("clip", [None, 1e-3])
def test_apply_matches_jax(clip):
    cfg = dict(log2_hashmap_size=LOG2T, clip_sdf=clip)
    jcfg, tcfg = jsdf.SDFConfig(**cfg), tsdf.SDFConfig(**cfg)
    assert tcfg.grid.level_params == jcfg.grid.level_params
    jp = jsdf.init(jax.random.PRNGKey(0), jcfg)
    # tables scaled up so the encode drives the output
    jp["encoder"] = jp["encoder"] * 1e3
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    own = tsdf.init(tcfg, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tckpt.flatten_tree(own)} == \
        {k: tuple(v.shape) for k, v in tckpt.flatten_tree(tp)}
    x = np.random.default_rng(1).uniform(-1, 1, (400, 3)).astype(np.float32)
    want = np.asarray(jsdf.apply(jp, jcfg, jnp.asarray(x)))
    got = tsdf.apply(tp, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    if clip:
        assert np.abs(got).max() <= clip and (np.abs(got) == clip).any()


def test_adam_and_mape_match_optax():
    """optax.adam(1e-3) on the MAPE's gradient, 3 updates; the MAPE's
    gradient at a zero difference is +1 / (|t| + 0.01), as jnp.abs's."""
    jp = jsdf.init(jax.random.PRNGKey(1), jsdf.SDFConfig(log2_hashmap_size=10))
    tp = tckpt.params_from_jax(jax.tree.map(np.asarray, jp))
    jo, to = optax.adam(1e-3), Optimizer(1e-3, None, b2=0.999, eps=1e-8)
    js, ts = jo.init(jp), to.init(tp)
    from test_torch_tensorf import _jpaths

    assert set(_jpaths(js)) == {k for k, _ in tckpt.flatten_tree(ts)}
    rng = np.random.default_rng(2)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, jp))
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update(tckpt.params_from_jax(g), ts)
        tp = apply_updates(tp, tu)
        got = dict(tckpt.flatten_tree(tp))
        for k, v in _jpaths(jp).items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6,
                                       atol=1e-9, err_msg=f"{step} {k}")
    from seal3d_tpu.utils.losses import mape_loss as j_mape

    target = np.array([[0.5], [-0.2], [0.0]], np.float32)
    pred = torch.tensor([[0.5], [0.1], [0.0]], requires_grad=True)
    (g,) = torch.autograd.grad(mape_loss(pred, torch.from_numpy(target)), pred)
    jg = jax.grad(lambda p: j_mape(p, jnp.asarray(target)))(
        jnp.asarray(pred.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    assert (g.numpy()[[0, 2]] > 0).all()


def test_fit_side_by_side():
    """100 steps of both trainers from the JAX init on the same batches
    (each package draws them from its own dataset with one seed): loss
    curves and the MAE before and after."""
    jds, tds = _datasets()
    jcfg = jsdf.SDFConfig(log2_hashmap_size=LOG2T)
    tcfg = tsdf.SDFConfig(log2_hashmap_size=LOG2T)
    jtr = JTrainer(jcfg, jds, num_points=POINTS, key=jax.random.PRNGKey(0))
    ttr = TTrainer(tcfg, tds, num_points=POINTS)
    ttr.params = tckpt.params_from_jax(jax.tree.map(np.asarray, jtr.params))
    ttr.opt_state = ttr.optimizer.init(ttr.params)
    e0j, e0t = jtr.evaluate(POINTS), ttr.evaluate(POINTS)
    jl = jtr.train(steps=STEPS, silent=True)
    tl = ttr.train(steps=STEPS, silent=True)
    e1j, e1t = jtr.evaluate(POINTS), ttr.evaluate(POINTS)
    print(f"\n[sdf parity] MAE reference {e0j:.5f} -> {e1j:.5f}, port "
          f"{e0t:.5f} -> {e1t:.5f}; last loss {jl:.5f} / {tl:.5f}")
    np.testing.assert_allclose(e0t, e0j, rtol=1e-4)
    assert e1j < 0.5 * e0j and e1t < 0.5 * e0t
    assert abs(e1t - e1j) <= MAE_RTOL * e1j, (e1j, e1t)
    assert ttr.train_stats["window_steps"] == STEPS - 48


def test_main_sdf_cli_with_a_mesh(tmp_path):
    obj, _, _, _ = _write_meshes(tmp_path)
    ws = str(tmp_path / "ws")
    tr = main_sdf.main([obj, "--device", "cpu", "--iters", "30",
                        "--num_points", "1024", "--log2_hashmap_size", "12",
                        "--mesh_resolution", "32", "--workspace", ws])
    path = os.path.join(ws, "sdf_mesh.ply")
    verts, faces = t_load_mesh(path)
    assert len(verts) > 0 and len(faces) > 0
    assert np.abs(verts).max() <= 1.0 + 1e-6
    assert np.isfinite(tr.evaluate(512))
    # the synthetic box at scale 0.6, no fit
    tr = main_sdf.main(["synthetic", "--device", "cpu", "--test",
                        "--log2_hashmap_size", "12", "--mesh_resolution",
                        "16", "--workspace", ws])
    np.testing.assert_allclose(np.abs(tr.dataset.verts).max(), 0.6,
                               rtol=1e-6)
