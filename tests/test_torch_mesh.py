"""Port parity of mesh extraction and export (seal3d_tpu_torch/runtime/
mesh_export.py) against the JAX package's on the CPU.

The marching tetrahedra are the same C++ in both packages (the port builds
its copy, csrc/mesh_extract.cpp, with g++ at first use): on the same grid
the meshes are bit-identical. `extract_geometry` queries an NGP converted
from the JAX package (fp32 `xla` backend) on the same lattice: the same
vertex and triangle counts and triangles, vertices within 1e-4. Where a
lattice node's density differs between the packages beyond fp32 rounding
(the MLP rounds its inputs to bf16, and an encode that differs in its last
bit flips that rounding at about one node in a few thousand), the vertices
next to that node (under 1% of them) are held to 1e-2 of the lattice
spacing instead. `save_mesh` writes the same text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.runtime import mesh_export as jmesh
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.runtime import mesh_export as tmesh
from seal3d_tpu_torch.train.checkpoint import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sphere_grid(r=48):
    lin = np.linspace(-1, 1, r, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    return 1.0 - np.sqrt(x * x + y * y + z * z), 2 / (r - 1)


def test_marching_tetrahedra_bit_identical():
    """tests/test_mesh_export.py's sphere through both packages: the same
    vertices and triangles bit for bit, a sphere of radius 0.5."""
    grid, spacing = _sphere_grid()
    kw = dict(origin=(-1, -1, -1), spacing=(spacing,) * 3)
    tv, tt = tmesh.marching_tetrahedra(grid, 0.5, **kw)
    jv, jt = jmesh.marching_tetrahedra(grid, 0.5, **kw)
    assert len(tv) > 500 and len(tt) > 500
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    radii = np.linalg.norm(tv, axis=1)
    np.testing.assert_allclose(radii.mean(), 0.5, atol=0.03)
    assert tt.min() >= 0 and tt.max() < len(tv)
    # an iso level the grid never crosses gives an empty mesh
    ev, et = tmesh.marching_tetrahedra(grid, 5.0, **kw)
    assert ev.shape == (0, 3) and et.shape == (0, 3)


def test_extract_geometry_of_a_converted_ngp_matches_jax():
    """A JAX NGP (xla backend, tables scaled so the density varies) carried
    into the port: extract_geometry at resolution 32 on the CPU against
    the JAX one at the same threshold; a padded last chunk (chunk 5000)
    gives the same mesh."""
    kw = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
              grid_backend="xla", gridtype="hash")
    jcfg, tcfg = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    p = jngp.init(jax.random.PRNGKey(0), jcfg)
    p = dict(p, encoder=p["encoder"] * 3e3)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    probe = np.random.default_rng(0).uniform(-1, 1, (4096, 3)) \
        .astype(np.float32)
    thr = float(np.median(np.asarray(
        jngp.density(p, jcfg, jnp.asarray(probe))["sigma"])))

    res = 32
    jv, jt = jmesh.extract_geometry(
        lambda x: jngp.density(p, jcfg, x)["sigma"], bound=1.0,
        resolution=res, threshold=thr)
    # the lattice nodes whose densities the packages round apart
    lin = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    nodes = np.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], -1)
    jd = np.asarray(jax.jit(lambda x: jngp.density(p, jcfg, x)["sigma"])(
        jnp.asarray(nodes)))
    td = tngp.density(tp, tcfg, torch.from_numpy(nodes))["sigma"].numpy()
    flipped = (np.abs(td - jd) > 1e-5 * np.abs(jd)).reshape(res, res, res)
    spacing = 2.0 / (res - 1)
    # a vertex lies on a lattice edge: its cell's 8 nodes hold both ends
    cell = np.clip(np.floor((jv + 1.0) / spacing + 1e-4).astype(int), 0,
                   res - 2)
    near = np.zeros(len(jv), bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                near |= flipped[cell[:, 2] + dz, cell[:, 1] + dy,
                                cell[:, 0] + dx]
    assert flipped.mean() < 1e-2 and near.mean() < 1e-2, (flipped.sum(),
                                                          near.sum())
    for chunk in (2**16, 5000):
        tv, tt = tmesh.extract_geometry(
            lambda x: tngp.density(tp, tcfg, x)["sigma"], bound=1.0,
            resolution=res, threshold=thr, chunk=chunk, device="cpu")
        assert len(jv) > 200
        assert tv.shape == jv.shape and tt.shape == jt.shape
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tv[~near], jv[~near], atol=1e-4)
        np.testing.assert_allclose(tv[near], jv[near], atol=1e-2 * spacing)
        assert (np.abs(tv) <= 1.0).all()


@pytest.mark.parametrize("ext", ["ply", "obj"])
def test_save_mesh_text_identical(tmp_path, ext):
    grid, spacing = _sphere_grid(16)
    verts, tris = tmesh.marching_tetrahedra(grid, 0.5, origin=(-1, -1, -1),
                                            spacing=(spacing,) * 3)
    tpath, jpath = tmp_path / f"t/mesh.{ext}", tmp_path / f"j/mesh.{ext}"
    tmesh.save_mesh(str(tpath), verts, tris)
    jmesh.save_mesh(str(jpath), verts, tris)
    assert tpath.read_text() == jpath.read_text()
    assert len(tpath.read_text().splitlines()) > len(verts)
