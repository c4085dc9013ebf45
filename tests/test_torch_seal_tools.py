"""Port parity of the Seal brush and anchor tools (seal3d_tpu_torch/seal/
mappers.py) and of the imaged colour edit against the JAX package on the
CPU.

The same configs build a mapper in both packages: line and curve strokes,
several strokes with a list `brushType`, a collinear stroke (qhull refuses
it and the border takes every representative), a `dry` stroke and an
anchor. Their data arrays agree to 1e-6. On 4,096 seeded points around each
edit `map_mask` agrees exactly except on points within 1e-6 of a boundary
(counted), and `map_to_origin` to 1e-5. The JAX package's own behavioural
tests of the tools (tests/test_seal.py) run on the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seal3d_tpu.seal import mappers as jmap
from seal3d_tpu_torch.seal import mappers as tmap
from test_torch_seal_cases import (CONFIGS, boundary_slack, brush,
                                   grid_stroke, points_around)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_mapper(config):
    return jmap.build_mapper(config)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mapper_data_matches_jax(name, tmp_path):
    """Every data array within 1e-6 of the JAX mapper's, the same flags and
    host fields, the workspace's debug mesh written; the JAX mapper
    cross-loaded with mapper_from_jax is the same mapper."""
    config = CONFIGS[name]
    jm = _jax_mapper(config)
    tm = tmap.build_mapper(config, workspace=str(tmp_path))
    out = "to.obj" if jm.kind == "anchor" else "to.ply"
    assert (tmp_path / out).exists()
    assert tm.kind == jm.kind and tm.flags == jm.flags
    assert tm.attenuation_mode == jm.attenuation_mode
    assert set(tm.data) == set(jm.data)
    for k, v in jm.data.items():
        assert tuple(tm.data[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(tm.data[k].numpy(), np.asarray(v),
                                   atol=1e-6, err_msg=k)
    for k in ("force_fill_bound", "map_bound", "pose_center"):
        np.testing.assert_allclose(getattr(tm, k), getattr(jm, k), atol=1e-6,
                                   err_msg=k)
    assert tm.pose_radius == pytest.approx(jm.pose_radius, rel=1e-6)
    cm = tmap.mapper_from_jax(
        jm.kind, {k: np.asarray(v) for k, v in jm.data.items()}, jm.flags,
        force_fill_bound=jm.force_fill_bound, map_bound=jm.map_bound,
        pose_center=jm.pose_center, pose_radius=jm.pose_radius,
        config=jm.config, attenuation_mode=jm.attenuation_mode)
    pts = points_around(jm, np.random.default_rng(1), 512)
    np.testing.assert_array_equal(tmap.map_mask(cm, _t(pts)).numpy(),
                                  tmap.map_mask(tm, _t(pts)).numpy())


def test_collinear_stroke_takes_the_hull_fallback():
    """qhull refuses a collinear stroke; the border then resamples every
    representative as a hull vertex (8 samples an edge), as the reference's
    geometry does."""
    from scipy.spatial import ConvexHull

    tm = tmap.build_mapper(CONFIGS["collinear"])
    reps = tm.data["reps"].numpy()
    with pytest.raises(RuntimeError):
        ConvexHull(np.stack([reps[:, 0], reps[:, 2]], -1))
    assert tm.data["border_points"].shape[0] == 8 * reps.shape[0]
    tl = tmap.build_mapper(CONFIGS["line"])
    assert tl.data["border_points"].shape[0] < 8 * tl.data["reps"].shape[0]
    normal = tm.data["normal_expand"].numpy()
    for planar in (True, False):
        np.testing.assert_array_equal(
            tmap._hull_border_points(reps, normal, planar=planar),
            jmap._hull_border_points(reps, normal, planar=planar))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mapper_ops_match_jax(name):
    """map_mask exact but within 1e-6 of a boundary (counted), map_to_origin
    within 1e-5, on 4,096 seeded points around the edit, with and without
    dirs; the mask is neither empty nor full."""
    jm = _jax_mapper(CONFIGS[name])
    tm = tmap.build_mapper(CONFIGS[name])
    pts = points_around(jm, np.random.default_rng(2))
    dirs = np.random.default_rng(3).normal(size=pts.shape).astype(np.float32)
    jmask = np.asarray(jmap.map_mask(jm, jnp.asarray(pts)))
    tmask = tmap.map_mask(tm, _t(pts)).numpy()
    jp, jd, jmask2 = jmap.map_to_origin(jm, jnp.asarray(pts), jnp.asarray(dirs))
    tp, td, tmask2 = tmap.map_to_origin(tm, _t(pts), _t(dirs))
    slack = boundary_slack(jm, pts)
    for a, b in ((tmask, jmask), (tmask2.numpy(), np.asarray(jmask2))):
        off = a != b
        assert (slack[off] < 1e-6).all(), slack[off]
        assert off.sum() <= 4, f"{int(off.sum())} points disagree"
    agree = tmask2.numpy() == np.asarray(jmask2)
    if name == "collinear":   # the stroke's map bound is flat in z
        assert not np.asarray(jmask2).any() and not tmask2.any()
    else:
        assert 0.02 < np.asarray(jmask2).mean() < 0.98
    np.testing.assert_allclose(tp.numpy()[agree], np.asarray(jp)[agree],
                               atol=1e-5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # outside the map the points come back unchanged
    outside = ~tmask2.numpy()
    if jm.kind == "brush":
        np.testing.assert_array_equal(tp.numpy()[outside], pts[outside])
    tp2, td2, _ = tmap.map_to_origin(tm, _t(pts), None)
    assert td2 is None
    np.testing.assert_array_equal(tp2.numpy(), tp.numpy())


def test_brush_row_blocks_give_the_same_answer(monkeypatch):
    """The [N, R] searches in blocks of a few rows equal one block."""
    tm = tmap.build_mapper(CONFIGS["strokes"])
    pts = _t(points_around(tm, np.random.default_rng(4), 1024))
    whole = tmap.map_to_origin(tm, pts, None)
    monkeypatch.setattr(tmap, "_PAIR_ENTRIES", 1000)
    parts = tmap.map_to_origin(tm, pts, None)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[2], parts[2])
    empty = torch.zeros((0, 3))
    out, _, mask = tmap.map_to_origin(tm, empty, None)
    assert out.shape == (0, 3) and mask.shape == (0,)


# ------------------------------------- the JAX package's behavioural tests

def test_brush_mapper_lift():
    """tests/test_seal.py::test_brush_mapper_lift on the port: points just
    above the painted plane map down by the pressure vector."""
    pts = grid_stroke((-0.2, 0.2), (-0.2, 0.2), 0.0)
    m = tmap.build_mapper(brush(pts, brushPressure=0.1,
                                attenuationDistance=0.0))
    q = torch.tensor([[0.0, 0.1, 0.0], [0.0, -0.05, 0.0], [0.9, 0.1, 0.0]])
    mask = tmap.map_mask(m, q).numpy()
    assert mask[0] and mask[1] and not mask[2]
    mapped, _, _ = tmap.map_to_origin(m, q, None)
    np.testing.assert_allclose(mapped[0].numpy(), [0.0, 0.0, 0.0], atol=0.02)


def test_anchor_mapper_pull():
    """tests/test_seal.py::test_anchor_mapper_pull on the port."""
    raw = grid_stroke((-0.2, 0.2), (-0.2, 0.2), 0.0, n=7)
    m = tmap.build_mapper({"type": "anchor", "raw": raw.tolist(),
                           "translation": [0.0, 0.3, 0.0], "radius": 0.25,
                           "scale": [1.0, 1.0, 1.0]})
    assert "map_source" in m.flags
    tip = torch.tensor([[0.0, 0.25, 0.0], [0.8, 0.8, 0.8]])
    mapped, _, mask = tmap.map_to_origin(m, tip, None)
    assert mask[0] and not mask[1]
    assert float(mapped[0, 1]) < 0.25   # pulled toward the source plane


def test_curve_brush_follows_curved_surface():
    """tests/test_seal.py::test_curve_brush_follows_curved_surface on the
    port: on a spherical cap the curve brush contains and un-lifts points
    all over the cap, the single-plane line fit misses its periphery."""
    rng = np.random.default_rng(3)
    theta = np.arccos(rng.uniform(np.cos(0.65), 1.0, 400))
    phi = rng.uniform(0, 2 * np.pi, 400)
    pts = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                    np.sin(theta) * np.sin(phi)], -1).astype(np.float32)
    pressure = 0.05
    m_curve, m_line = (tmap.build_mapper(brush(
        pts, btype, brushPressure=pressure, attenuationDistance=0.0,
        simplifyVoxel=12)) for btype in ("curve", "line"))
    edge = np.abs(theta - 0.6) < 0.04
    surf = pts[edge]
    lifted = _t(surf + pressure * surf / np.linalg.norm(surf, axis=-1,
                                                        keepdims=True))
    mask_curve = tmap.map_mask(m_curve, lifted).numpy()
    mask_line = tmap.map_mask(m_line, lifted).numpy()
    assert mask_curve.mean() > 0.9, mask_curve.mean()
    assert mask_line.mean() < 0.9, mask_line.mean()
    mapped, _, mask = tmap.map_to_origin(m_curve, lifted, None)
    err_curve = np.abs(np.linalg.norm(mapped.numpy()[mask.numpy()], axis=-1)
                       - 1.0)
    assert err_curve.mean() < 0.01, err_curve.mean()
    mapped_l, _, _ = tmap.map_to_origin(m_line, lifted, None)
    err_line = np.abs(np.linalg.norm(mapped_l.numpy()[mask_line], axis=-1)
                      - 1.0)
    assert err_line.mean() > 3.0 * max(err_curve.mean(), 1e-4)


# ------------------------------------------------------ the imaged colour edit

def test_image_colour_edit_matches_jax(tmp_path):
    """`imageConfig`: a texture projected onto a plane and blended by its
    alpha; the port's map_color against the JAX mapper's on a bbox edit,
    with a 4-channel and a 3-channel PNG."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    for channels in (4, 3):
        img = rng.integers(0, 256, (12, 16, channels)).astype(np.uint8)
        path = str(tmp_path / f"tex{channels}.png")
        assert cv2.imwrite(path, img)
        config = {"type": "bbox",
                  "raw": (np.stack(np.meshgrid(*[np.linspace(-0.2, 0.2, 3)]
                                               * 3, indexing="ij"), -1)
                          .reshape(-1, 3) + [0.3, 0.1, 0.0]).tolist(),
                  "transform": np.eye(4).tolist(), "scale": [1.0, 1.0, 1.0],
                  "rgbLightOffset": 0.05,
                  "imageConfig": {"path": path, "o": [0.1, -0.1, -0.2],
                                  "w": [0.5, -0.1, -0.2],
                                  "h": [0.1, 0.3, -0.2]}}
        jm, tm = jmap.build_mapper(config), tmap.build_mapper(config)
        assert "image" in tm.flags and tm.flags == jm.flags
        for k in ("image", "image_mask", "v_image_norm", "v_image_o"):
            np.testing.assert_allclose(tm.data[k].numpy(),
                                       np.asarray(jm.data[k]), atol=1e-7)
        pts = points_around(jm, np.random.default_rng(6), 2048)
        dirs = np.tile(np.float32([[0, 0, 1]]), (len(pts), 1))
        rgb = rng.uniform(0, 1, pts.shape).astype(np.float32)
        jp, jd, jmask = jmap.map_to_origin(jm, jnp.asarray(pts),
                                           jnp.asarray(dirs))
        jc = np.asarray(jmap.map_color(jm, jp, jd, jnp.asarray(rgb),
                                       mask=jmask))
        tp, td, tmask = tmap.map_to_origin(tm, _t(pts), _t(dirs))
        tc = tmap.map_color(tm, tp, td, _t(rgb), mask=tmask).numpy()
        np.testing.assert_allclose(tc, jc, atol=1e-6)
        assert np.abs(tc - rgb).max() > 0.05   # the texture changed colours
