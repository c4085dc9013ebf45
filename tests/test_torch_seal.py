"""Port parity of the Seal editing layer (seal3d_tpu_torch/seal/) against
the JAX package on the CPU: colour helpers, geometry, the bbox mapper, the
occupancy hacks, the mapped teacher field, the pretraining shells, one
pretrain batch's loss and table gradients, the teacher's demand probe and
renders, the hacked and restored grid, and the depth term of the train loss.

The same numpy inputs go to both sides; a JAX mapper is also cross-loaded
into the port with `mapper_from_jax`. fp32 elementwise code agrees to 1e-6
and its masks exactly; field outputs to 1e-5 on the fp32 `xla` backend and
2e-2 through the reference's interpreted halo kernel (bf16 table).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_seal_cases as tool_cases
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.render import occupancy as jocc
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as j_render_rays
from seal3d_tpu.seal import color as jcolor
from seal3d_tpu.seal import geometry as jgeo
from seal3d_tpu.seal import mappers as jmap
from seal3d_tpu.seal import renderer as jsr
from seal3d_tpu.seal import trainer as jst
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render import occupancy as tocc
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.seal import color as tcolor
from seal3d_tpu_torch.seal import geometry as tgeo
from seal3d_tpu_torch.seal import mappers as tmap
from seal3d_tpu_torch.seal import renderer as tsr
from seal3d_tpu_torch.seal import trainer as tst
from seal3d_tpu_torch.train.checkpoint import flatten_tree, params_from_jax
from seal3d_tpu_torch.train.trainer import StepRandom
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg


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


def _translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def _cube_points(center, half, n=5):
    g = np.linspace(-half, half, n)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return pts + np.asarray(center)


def _rot_scale_config():
    th = np.pi / 2
    tf = np.eye(4)
    tf[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]]
    return {"type": "bbox", "raw": _cube_points([0, 0, 0], 0.2).tolist(),
            "transform": tf.tolist(), "scale": [2.0, 1.0, 1.0]}


CONFIGS = {
    "translate": {"type": "bbox",
                  "raw": _cube_points([0.3, 0.0, 0.0], 0.15).tolist(),
                  "transform": _translate([0.0, 0.4, 0.0]).tolist(),
                  "scale": [1.0, 1.0, 1.0]},
    "rot_scale": _rot_scale_config(),
    "map_source_hsv_rgb": {
        "type": "bbox", "raw": _cube_points([0.3, 0.1, 0.0], 0.2, 4).tolist(),
        "transform": _translate([0.0, 0.35, 0.0]).tolist(),
        "scale": [1.0, 1.0, 1.0], "mapSource": [0.9, 0.9, 0.9],
        "boundType": "both", "hsv": [0.1, -0.2, 0.05],
        "rgb": [1.0, 0.2, 0.1], "rgbLightOffset": 0.05},
}


# ------------------------------------------------------------ colour, geometry

def test_color_helpers_match_jax():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    rgb[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0]]
    pairs = [(tcolor.rgb_to_hsv, jcolor.rgb_to_hsv),
             (tcolor.rgb_to_hsl, jcolor.rgb_to_hsl),
             (lambda x: tcolor.hsv_to_rgb(tcolor.rgb_to_hsv(x)),
              lambda x: jcolor.hsv_to_rgb(jcolor.rgb_to_hsv(x))),
             (lambda x: tcolor.hsl_to_rgb(tcolor.rgb_to_hsl(x)),
              lambda x: jcolor.hsl_to_rgb(jcolor.rgb_to_hsl(x)))]
    for tf, jf in pairs:
        np.testing.assert_allclose(tf(_t(rgb)).numpy(),
                                   np.asarray(jf(jnp.asarray(rgb))), atol=1e-6)
    back = tcolor.hsv_to_rgb(tcolor.rgb_to_hsv(_t(rgb)))
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)
    back = tcolor.hsl_to_rgb(tcolor.rgb_to_hsl(_t(rgb)))
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)
    mod = np.array([0.3, -0.1, 0.2], np.float32)
    np.testing.assert_allclose(
        tcolor.modify_hsv(_t(rgb), _t(mod)).numpy(),
        np.asarray(jcolor.modify_hsv(jnp.asarray(rgb), jnp.asarray(mod))),
        atol=1e-6)
    mask = rng.uniform(size=512) > 0.5
    for m in (None, mask):
        got = tcolor.modify_rgb(_t(rgb), _t(mod.clip(0, 1)), 0.1,
                                mask=None if m is None else _t(m))
        ref = jcolor.modify_rgb(jnp.asarray(rgb), jnp.asarray(mod.clip(0, 1)),
                                0.1, mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_geometry_matches_jax():
    verts, faces = tgeo.box_mesh_from_aabb(np.array([[-1, -1, -1], [1, 1, 1.0]]))
    tris = verts[faces]
    pts = np.array([[0.0, 0, 0], [0.5, 0.5, -0.5], [1.5, 0, 0], [0, -2, 0]],
                   np.float32)
    inside = tgeo.points_in_mesh(_t(pts), _t(tris)).numpy()
    np.testing.assert_array_equal(inside, [True, True, False, False])
    rng = np.random.default_rng(1)
    p = rng.uniform(-1.5, 1.5, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.points_in_mesh(_t(p), _t(tris)).numpy(),
        np.asarray(jgeo.points_in_mesh(jnp.asarray(p), jnp.asarray(tris))))
    np.testing.assert_array_equal(
        tgeo.moller_trumbore_any(_t(p), _t(d), _t(tris)).numpy(),
        np.asarray(jgeo.moller_trumbore_any(jnp.asarray(p), jnp.asarray(d),
                                            jnp.asarray(tris))))
    n, c = np.array([0.2, 1.0, -0.3], np.float32), np.array([0.1, 0, 0.2],
                                                           np.float32)
    np.testing.assert_allclose(
        tgeo.project_points(_t(n), _t(c), _t(p)).numpy(),
        np.asarray(jgeo.project_points(jnp.asarray(n), jnp.asarray(c),
                                       jnp.asarray(p))), atol=1e-6)
    np.testing.assert_allclose(
        tgeo.point_triangle_distance(_t(p[:300]), _t(tris)).numpy(),
        np.asarray(jgeo.point_triangle_distance(jnp.asarray(p[:300]),
                                                jnp.asarray(tris))), atol=1e-5)
    box_j, box_t = jgeo.obb_from_points(p), tgeo.obb_from_points(p)
    for k in box_j:
        np.testing.assert_array_equal(box_t[k], box_j[k])


# ----------------------------------------------------------------- the mapper

def _query_points(m, rng):
    lo = m.force_fill_bound[:, 0].min(0) - 0.15
    hi = m.force_fill_bound[:, 1].max(0) + 0.15
    pts = rng.uniform(lo, hi, (4000, 3)).astype(np.float32)
    dirs = rng.normal(size=(4000, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=1, keepdims=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bbox_mapper_matches_jax(name, tmp_path):
    config = CONFIGS[name]
    jm = jmap.build_mapper(config)
    tm = tmap.build_mapper(config, workspace=str(tmp_path))
    assert (tmp_path / "from.obj").exists() and (tmp_path / "to.obj").exists()
    assert tm.kind == jm.kind and tm.flags == jm.flags
    assert set(tm.data) == set(jm.data)
    for k, v in jm.data.items():
        np.testing.assert_allclose(tm.data[k].numpy(), np.asarray(v),
                                   atol=1e-7, err_msg=k)
    for k in ("force_fill_bound", "map_bound", "pose_center"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k))
    assert tm.pose_radius == jm.pose_radius
    # the JAX mapper's arrays carried into the port give the same mapper
    cm = tmap.mapper_from_jax(
        jm.kind, {k: np.asarray(v) for k, v in jm.data.items()}, jm.flags,
        force_fill_bound=jm.force_fill_bound, map_bound=jm.map_bound,
        pose_center=jm.pose_center, pose_radius=jm.pose_radius,
        config=jm.config)

    pts, dirs = _query_points(jm, np.random.default_rng(2))
    colors = np.random.default_rng(3).uniform(0, 1, (4000, 3)) \
        .astype(np.float32)
    jp, jd, jmask = jmap.map_to_origin(jm, jnp.asarray(pts), jnp.asarray(dirs))
    assert 0.02 < np.asarray(jmask).mean() < 0.98
    jc = jmap.map_color(jm, jp, jd, jnp.asarray(colors), mask=jmask)
    for m in (tm, cm):
        np.testing.assert_array_equal(tmap.map_mask(m, _t(pts)).numpy(),
                                      np.asarray(jmap.map_mask(
                                          jm, jnp.asarray(pts))))
        tp, td, tmask = tmap.map_to_origin(m, _t(pts), _t(dirs))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
        tc = tmap.map_color(m, tp, td, _t(colors), mask=tmask)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    tp, td, _ = tmap.map_to_origin(tm, _t(pts), None)
    assert td is None


def test_bbox_mapper_semantics():
    """tests/test_seal.py's translate and rotation + scale cases."""
    m = tmap.build_mapper(CONFIGS["translate"])
    tgt = _cube_points([0.3, 0.4, 0.0], 0.1).astype(np.float32)
    far = _cube_points([-0.6, -0.6, -0.6], 0.05).astype(np.float32)
    assert tmap.map_mask(m, _t(tgt)).float().mean() > 0.9
    assert not tmap.map_mask(m, _t(far)).any()
    mapped, _, mask = tmap.map_to_origin(m, _t(tgt), None)
    np.testing.assert_allclose(mapped[mask].numpy(),
                               tgt[mask.numpy()] - [0.0, 0.4, 0.0], atol=1e-5)
    m = tmap.build_mapper(CONFIGS["rot_scale"])
    mapped, mdirs, mask = tmap.map_to_origin(
        m, torch.tensor([[0.0, 0.3, 0.0]]), torch.tensor([[0.0, 1.0, 0.0]]))
    assert bool(mask[0])
    np.testing.assert_allclose(mapped[0].numpy(), [0.15, 0, 0], atol=1e-5)
    np.testing.assert_allclose(mdirs[0].numpy(), [1.0, 0, 0], atol=1e-5)


def test_mapper_config_file_and_unported_tools(tmp_path):
    """The repo's seal.json parses like json5 would; comments and trailing
    commas are stripped; brush and anchor configs build their tools; an
    unknown tool raises."""
    cfg = tmap.load_mapper_config("seal_config_bbox")
    with open("seal_config_bbox/seal.json") as f:
        assert cfg == json.load(f)
    (tmp_path / "seal.json").write_text(
        '{\n  // the tool\n  "type": "bbox", /* block */\n'
        '  "note": "a // inside a string, stays",\n'
        '  "raw": [[0, 0, 0], [1, 1, 1],],\n  "scale": [1, 1, 1],\n}\n')
    cfg = tmap.load_mapper_config(str(tmp_path))
    assert cfg == {"type": "bbox", "note": "a // inside a string, stays",
                   "raw": [[0, 0, 0], [1, 1, 1]], "scale": [1, 1, 1]}
    for name, kind in (("line", "brush"), ("anchor", "anchor")):
        (tmp_path / "seal.json").write_text(json.dumps(
            tool_cases.CONFIGS[name], indent=1))
        m = tmap.build_mapper(tmap.load_mapper_config(str(tmp_path)))
        assert m.kind == kind and m.config == tool_cases.CONFIGS[name]
    with pytest.raises(NotImplementedError, match="unknown seal tool"):
        tmap.build_mapper({"type": "lasso"})


# ----------------------------------------------------------- occupancy hacks

def test_force_fill_and_hacks_exact():
    bounds = np.array([[[-0.1, -0.1, -0.1], [0.1, 0.1, 0.1]],
                       [[0.3, 0.2, -0.4], [0.52, 0.41, -0.2]]], np.float32)
    for cascades, bound in ((1, 1.0), (2, 2.0)):
        np.testing.assert_array_equal(
            tsr.force_fill_cells(bounds, cascades, bound),
            jsr.force_fill_cells(bounds, cascades, bound))
    cells = tsr.force_fill_cells(bounds[:1], 1, 1.0)
    assert 1500 < len(cells) < 5000
    tb, tm_ = tsr.cells_to_byte_masks(cells)
    jb, jm_ = jsr.cells_to_byte_masks(cells)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tm_, jm_)
    rng = np.random.default_rng(4)
    bf = rng.integers(0, 256, 2**21 // 8).astype(np.uint8)
    hacked = tsr.hack_bitfield(_t(bf), _t(tb).long(), _t(tm_))
    np.testing.assert_array_equal(
        hacked.numpy(), np.asarray(jsr.hack_bitfield(
            jnp.asarray(bf), jnp.asarray(jb), jnp.asarray(jm_))))
    zero = tsr.hack_bitfield(torch.zeros(2**21 // 8, dtype=torch.uint8),
                             _t(tb).long(), _t(tm_))
    assert int(np.unpackbits(zero.numpy()).sum()) == len(cells)
    grid = rng.uniform(0, 100, (1, 2**21)).astype(np.float32)
    np.testing.assert_array_equal(
        tsr.hack_grid(_t(grid), _t(cells)).numpy(),
        np.asarray(jsr.hack_grid(jnp.asarray(grid), jnp.asarray(cells))))
    empty = torch.zeros(0, dtype=torch.int64)
    assert tsr.hack_bitfield(_t(bf), empty, empty.to(torch.uint8)) is not None
    assert tsr.hack_grid(_t(grid), empty).shape == grid.shape


# --------------------------------------------------------- the teacher field

TEACHER_TOOLS = {"bbox": CONFIGS["map_source_hsv_rgb"],
                 "brush_line": tool_cases.CONFIGS["line"],
                 "brush_curve": tool_cases.CONFIGS["curve"],
                 "anchor": tool_cases.CONFIGS["anchor"]}


@pytest.mark.parametrize("tool", sorted(TEACHER_TOOLS))
@pytest.mark.parametrize("backend,gridtype,tol", [
    ("xla", "hash", 1e-5), ("halo", "wrap", 2e-2)])
def test_teacher_field_matches_jax(backend, gridtype, tol, tool):
    """`make_teacher_field(...).apply / density / color` with carried params,
    plain and with a secondary teacher, through each tool's mapper (the
    bbox with map_source and colour edits, a line and a curve brush, an
    anchor); the halo case goes through the reference's interpreted kernel
    (bf16 table).

    The bbox case holds every point. The brush and anchor cases hold the
    mapped points to 1e-6 and every output to `tol` except at points where
    the base fields themselves, fed the identical mapped point, differ by
    more than `tol`: the MLPs round their inputs to bf16, and an fp32
    rounding difference of the two packages' encodes flips that rounding at
    about one point in a few thousand. Those points are counted (at most 3
    of 3000 per output)."""
    kw = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
              grid_backend=backend, gridtype=gridtype)
    jcfg, tcfg = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    config = TEACHER_TOOLS[tool]
    jm, tm = jmap.build_mapper(config), tmap.build_mapper(config)

    def scaled(key):
        p = jngp.init(jax.random.PRNGKey(key), jcfg)
        return dict(p, encoder=p["encoder"] * 5e3,
                    encoder_color=p["encoder_color"] * 5e3)

    jp, jp2 = scaled(0), scaled(1)
    tp, tp2 = (params_from_jax(jax.tree.map(np.asarray, p))
               for p in (jp, jp2))
    n = 256 if backend == "halo" else 3000
    pts, dirs = _query_points(jm, np.random.default_rng(5))
    pts, dirs = pts[:n], dirs[:n]
    jx, jdir, jmask = (np.asarray(a) for a in jmap.map_to_origin(
        jm, jnp.asarray(pts), jnp.asarray(dirs)))
    tx, tdir, tmask = (a.numpy() for a in tmap.map_to_origin(
        tm, _t(pts), _t(dirs)))
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_allclose(tx, jx, atol=1e-6)
    np.testing.assert_allclose(tdir, jdir, atol=1e-6)

    def base_off(sec, jfn, tfn):
        """Rows where the base fields (the secondary one inside the mask
        where there is one) differ by more than tol on the JAX-mapped
        points; none for the bbox, which holds every point."""
        if tool == "bbox":
            return np.zeros(n, bool)
        offs = [_rows_off(tfn(t_p, _t(jx), _t(jdir)),
                          jfn(j_p, jnp.asarray(jx), jnp.asarray(jdir)), tol)
                for j_p, t_p in ((jp, tp), (jp2, tp2))]
        return np.where(jmask, offs[1], offs[0]) if sec else offs[0]

    def check(t_out, j_out, exempt):
        off = _rows_off(t_out, j_out, tol)
        assert not (off & ~exempt).any(), np.nonzero(off & ~exempt)
        assert exempt.sum() <= 3, int(exempt.sum())

    for sec in (False, True):
        jf = jsr.make_teacher_field(jngp, jm, jcfg,
                                    *((jngp, jcfg, jp2) if sec else ()))
        tf = tsr.make_teacher_field(tngp, tm, tcfg,
                                    *((tngp, tcfg, tp2) if sec else ()))
        js, jc = jf.apply(jp, jcfg, jnp.asarray(pts), jnp.asarray(dirs))
        ts, tc = tf.apply(tp, tcfg, _t(pts), _t(dirs))
        exempt = base_off(
            sec, lambda p, x, d: _log1p_sigma_rgb(jngp.apply(p, jcfg, x, d)),
            lambda p, x, d: _log1p_sigma_rgb(tngp.apply(p, tcfg, x, d)))
        check(_log1p_sigma_rgb((ts, tc)), _log1p_sigma_rgb((js, jc)), exempt)
        if backend == "halo":
            continue
        jd = jf.density(jp, jcfg, jnp.asarray(pts))
        td = tf.density(tp, tcfg, _t(pts))
        exempt = base_off(
            sec, lambda p, x, d: np.log1p(np.asarray(
                jngp.density(p, jcfg, x)["sigma"])),
            lambda p, x, d: np.log1p(tngp.density(p, tcfg, x)["sigma"]
                                     .numpy()))
        check(np.log1p(td["sigma"].numpy()),
              np.log1p(np.asarray(jd["sigma"])), exempt)
        jcol = jf.color(jp, jcfg, jnp.asarray(pts), jnp.asarray(dirs),
                        jd["geo_feat"])
        tcol = tf.color(tp, tcfg, _t(pts), _t(dirs), td["geo_feat"])
        # colour reads the primary teacher alone, on its own geo_feat
        exempt = base_off(
            False, lambda p, x, d: np.asarray(jngp.color(
                p, jcfg, x, d, jngp.density(p, jcfg, x)["geo_feat"])),
            lambda p, x, d: tngp.color(
                p, tcfg, x, d, tngp.density(p, tcfg, x)["geo_feat"]).numpy())
        check(tcol.numpy(), np.asarray(jcol), exempt)


def _log1p_sigma_rgb(out):
    """[M, 4]: log1p(sigma) beside rgb, from either package's (sigma, rgb)."""
    sigma, rgb = (np.asarray(a) if not isinstance(a, torch.Tensor)
                  else a.numpy() for a in out)
    return np.concatenate([np.log1p(sigma)[:, None], rgb], -1)


def _rows_off(a, b, tol):
    """Rows of two [M] or [M, k] arrays that differ by more than tol."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return (d.reshape(d.shape[0], -1) > tol).any(-1)


# ------------------------------------------------- the student trainer, shared

NGP_KW = dict(bound=1.0, log2_hashmap_size=12, num_levels=4)
OPTS = dict(bound=1.0, num_steps=32, upsample_steps=0, min_near=0.05,
            budget_per_ray=24, num_candidates=128, max_steps=256,
            coarse_steps=32)
TCFG = dict(lr=1e-2, max_steps=100, num_rays=64, eval_chunk=192,
            eval_budget_per_ray=32, random_bg=False)
EDIT = {"type": "bbox",
        "raw": _cube_points(np.array([0.3, 0.1, 0.0]), 0.2, n=3).tolist(),
        "transform": _translate(np.array([0.0, 0.3, 0.0])).tolist(),
        "scale": [1.0, 1.0, 1.0]}


@pytest.fixture(scope="module")
def students():
    """A JAX and a port SealTrainer over the same teacher params (JAX init,
    tables scaled up so the encode drives the field), the analytic scene's
    occupancy as the teacher bitfield, two 24x24 views."""
    ds = JScene().make_dataset(n_views=2, h=24, w=24, seed=0)
    occ = jocc.occupancy_update(jocc.occupancy_init(cascades=1),
                                JScene().density, jax.random.PRNGKey(2),
                                bound=1.0, density_thresh=0.01, full=True)
    jcfg, tcfg = jngp.NGPConfig(**NGP_KW), tngp.NGPConfig(**NGP_KW)
    p = jngp.init(jax.random.PRNGKey(0), jcfg)
    p = dict(p, encoder=p["encoder"] * 5e3,
             encoder_color=p["encoder_color"] * 5e3)
    js = jst.SealTrainer(jngp, jcfg, JOpts(**OPTS), JCfg(**TCFG),
                         jmap.build_mapper(EDIT), teacher_params=p,
                         teacher_bitfield=occ.bitfield, dataset=ds,
                         key=jax.random.PRNGKey(1))
    js.init_state()
    js.state = js.state._replace(params=jax.tree.map(jnp.copy, p),
                                 ema_params=jax.tree.map(jnp.copy, p))
    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    tp = params_from_jax(jax.tree.map(np.asarray, p))
    ts = tst.SealTrainer(tngp, tcfg, TOpts(**OPTS), TCfg(**TCFG),
                         tmap.build_mapper(EDIT), teacher_params=tp,
                         teacher_bitfield=_t(occ.bitfield), dataset=tds,
                         device="cpu")
    ts.init_state()
    ts.state = ts.state._replace(
        params=params_from_jax(jax.tree.map(np.asarray, p)),
        ema_params=params_from_jax(jax.tree.map(np.asarray, p)))
    pkw = dict(epochs=2, batch_size=4096, lr=0.05, local_point_step=0.05,
               local_angle_step=90, surrounding_point_step=0.1,
               global_point_step=0.3)
    js.init_pretraining(jst.PretrainConfig(**pkw))
    ts.init_pretraining(tst.PretrainConfig(**pkw))
    return js, ts, ds


def test_sample_grid_points_exact():
    bounds = np.array([[[0.1, 0.2, -0.2], [0.5, 0.6, 0.2]],
                       [[-1, -1, -1], [1, 1, 1]]], np.float32)
    for step, angle, cap in ((0.05, 45.0, 4_000_000), (0.01, 90.0, 5000)):
        jp, jd = jst.sample_grid_points(bounds, step, angle, cap)
        tp, td = tst.sample_grid_points(bounds, step, angle, cap)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(td, jd)
    assert tst.PretrainConfig() == tst.PretrainConfig(
        **dataclasses.asdict(jst.PretrainConfig()))


def test_pretraining_shells_match_jax(students):
    """Points, dirs and weights exact (shell directions come from the same
    numpy generators on both sides); the teacher's sigma and colour to the
    fp32 field's tolerance."""
    js, ts, _ = students
    assert list(ts.pretrain_data) == list(js.pretrain_data) == [
        "local", "surrounding", "global"]
    assert ts.teacher_field is not None and ts.is_pretraining
    for k, jv in js.pretrain_data.items():
        tv = ts.pretrain_data[k]
        assert tv["n_batches"] == jv["n_batches"]
        for f in ("points", "dirs", "weight"):
            np.testing.assert_array_equal(tv[f].numpy(), np.asarray(jv[f]),
                                          err_msg=f"{k}/{f}")
        np.testing.assert_allclose(np.log1p(tv["sigma"].numpy()),
                                   np.log1p(np.asarray(jv["sigma"])),
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(tv["color"].numpy(),
                                   np.asarray(jv["color"]), atol=1e-5,
                                   err_msg=k)
        assert float(tv["weight"].sum()) > 0
        assert float(tv["weight"].reshape(-1)[-1]) == 0.0  # padded tail


def test_pretrain_batch_loss_grads_and_update(students):
    """The loss and table gradients of one shell batch vs jax.value_and_grad
    of the reference's loss; then one pretrain step on both sides: tables
    move alike (Adam at the constant rate), MLP leaves do not move."""
    js, ts, _ = students
    jsrc, tsrc = js.pretrain_data["local"], ts.pretrain_data["local"]
    jbatch = {k: jsrc[k][0] for k in tst._BATCH_KEYS}
    tbatch = {k: tsrc[k][0] for k in tst._BATCH_KEYS}

    def jloss(p):
        sigma, color = jngp.apply(p, js.fcfg, jbatch["points"], jbatch["dirs"])
        w = jbatch["weight"]
        wsum = jnp.maximum(w.sum(), 1e-6)
        sl = (jnp.abs(jnp.log1p(sigma) - jnp.log1p(jbatch["sigma"])) * w) \
            .sum() / wsum
        return sl + (jnp.abs(color - jbatch["color"]) * w[:, None]).sum() \
            / (3 * wsum)

    # a student that differs from the teacher, so the loss is not ~0
    rng = np.random.default_rng(6)
    noise = {k: rng.normal(0, 0.05, v.shape).astype(np.float32)
             for k, v in js.state.params.items() if "encoder" in k}
    jp = dict(js.state.params,
              **{k: js.state.params[k] + v for k, v in noise.items()})
    tp = dict(ts.state.params,
              **{k: ts.state.params[k] + _t(v) for k, v in noise.items()})
    jl, jg = jax.value_and_grad(jloss)(jp)
    tabs = {k: tp[k].clone().requires_grad_() for k in noise}
    tl = ts.pretrain_loss({**tp, **tabs}, tbatch)
    tg = torch.autograd.grad(tl, list(tabs.values()))
    assert float(jl) > 0.01
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k, g in zip(tabs, tg):
        ref = np.asarray(jg[k])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(g.numpy() / scale, ref / scale, atol=1e-2,
                                   err_msg=k)

    js.state = js.state._replace(params=jp)
    ts.state = ts.state._replace(params=tp)
    before = {k: v.clone() for k, v in flatten_tree(ts.state.params)}
    jparams, js._pre_opt_state, jema, jl2 = js._pretrain_step(
        js.state.params, js._pre_opt_state, js.state.ema_params, jbatch)
    # the reference's step donates its inputs: keep its outputs as the state
    js.state = js.state._replace(params=jparams, ema_params=jema)
    tl2 = ts._pretrain_step(tbatch)
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=1e-4)
    jflat = dict(zip([k for k, _ in flatten_tree(ts.state.params)],
                     jax.tree.leaves(jparams)))
    jema_flat = dict(zip([k for k, _ in flatten_tree(ts.state.ema_params)],
                         jax.tree.leaves(jema)))
    for k, v in flatten_tree(ts.state.params):
        if "encoder" in k:
            moved = (v - before[k]).abs()
            # Adam's first step moves every touched entry by the rate
            assert float(moved.max()) == pytest.approx(0.05, rel=1e-3)
            agree = (np.sign((v - before[k]).numpy())
                     == np.sign(np.asarray(jflat[k]) - before[k].numpy()))
            assert agree.mean() > 0.999, k
        else:
            assert torch.equal(v, before[k]), k
            np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]))
    for k, v in flatten_tree(ts.state.ema_params):
        np.testing.assert_allclose(v.numpy(), np.asarray(jema_flat[k]),
                                   atol=2e-3, err_msg=k)


def test_pretrain_epochs_and_one_epoch(students):
    js, ts, _ = students
    first = ts.pretrain_one_epoch()
    losses = ts.pretrain_epochs(3)
    assert losses.shape == (3,) and np.all(np.isfinite(losses))
    assert losses[-1] < first
    # the student's bitfield now holds the force-fill
    forced = tsr.hack_bitfield(torch.zeros_like(ts.state.occ.bitfield),
                               ts._hack_bytes, ts._hack_masks)
    assert bool(((ts.state.occ.bitfield & forced) == forced).all())
    assert int(forced.to(torch.int64).sum()) > 0


def test_teacher_demand_and_covering_frac_equal(students):
    js, ts, ds = students
    chunk = 192
    jro, jrd, _ = js._teacher_view_setup(ds.poses[0], 24, 24, chunk)
    tro, trd, _ = ts._teacher_view_setup(ds.poses[0], 24, 24, chunk)
    np.testing.assert_allclose(tro.numpy(), np.asarray(jro), atol=1e-6)
    np.testing.assert_allclose(trd.numpy(), np.asarray(jrd), atol=1e-6)
    np.testing.assert_array_equal(ts.teacher_bitfield.numpy(),
                                  np.asarray(js.teacher_bitfield))
    with jax.disable_jit():   # eager, as the port: no FMA contraction
        jd = [int(js._teacher_demand(js.teacher_bitfield, jro[c], jrd[c]))
              for c in range(jro.shape[0])]
    td = [int(ts._teacher_demand(ts.teacher_bitfield, tro[c], trd[c]))
          for c in range(tro.shape[0])]
    assert td == jd and max(td) > 0
    for need in (0, 1, 100, 1000, 3000, 5000, 6100, 7000):
        assert ts._covering_frac(float(need), chunk) == js._covering_frac(
            float(need), chunk), need
    assert ts._covering_frac(0.0, chunk) == 0.0
    assert ts._covering_frac(1e9, chunk) is None


def test_packed_teacher_render_matches_grid_branch_and_jax(students):
    """tests/test_seal.py::test_packed_teacher_render_matches_dense in the
    port, and the port's teacher view against the JAX one."""
    js, ts, ds = students
    n_chunks = -(-24 * 24 // 192)
    img_d, dep_d = ts.render_teacher_view(ds.poses[0], fracs=[None] * n_chunks)
    img_p, dep_p = ts.render_teacher_view(ds.poses[0])      # probe path
    np.testing.assert_allclose(img_p.numpy(), img_d.numpy(), atol=2e-4)
    np.testing.assert_allclose(dep_p.numpy(), dep_d.numpy(), atol=1e-3)
    tro, trd, _ = ts._teacher_view_setup(ds.poses[0], 24, 24, 192)
    fracs = [ts._covering_frac(float(ts._teacher_demand(
        ts.teacher_bitfield, tro[c], trd[c])), 192) for c in range(n_chunks)]
    assert any(f not in (None, 0.0) for f in fracs), fracs
    jimg, jdep = js.render_teacher_view(ds.poses[0], fracs=[None] * n_chunks)
    np.testing.assert_allclose(img_d.numpy(), jimg, atol=1e-4)
    np.testing.assert_allclose(dep_d.numpy(), jdep, atol=1e-3)
    assert float((img_d.numpy() < 0.99).mean()) > 0.02   # not background only


def test_proxy_datasets_and_depth_term(students):
    """`proxy_datasets` fills uint8 images and float depths; the train loss
    over such a dataset adds the squared depth error, as the reference's."""
    js, ts, ds = students
    secs = ts.proxy_datasets()
    assert secs > 0
    pds = ts.dataset
    assert pds.images.dtype == np.uint8 and pds.images.shape == (2, 24, 24, 3)
    assert pds.depths.dtype == np.float32 and pds.depths.shape == (2, 24, 24)
    assert pds.depths.max() > 0 and ts._depths is not None
    img, dep = ts.render_teacher_view(ds.poses[1])
    np.testing.assert_array_equal(
        pds.images[1], (img.clamp(0, 1) * 255).to(torch.uint8).numpy())
    np.testing.assert_array_equal(pds.depths[1], dep.numpy())

    # the earlier tests trained the two students apart: same params again
    ts.state = ts.state._replace(
        params=params_from_jax(jax.tree.map(np.asarray, js.state.params)))
    rng = np.random.default_rng(8)
    inds = rng.integers(0, 24 * 24, 64)
    rand = StepRandom(img_idx=torch.tensor(1), inds=_t(inds).long(), bg=None,
                      jitter=torch.zeros(64))
    batch = ts.sample_batch(rand)
    np.testing.assert_array_equal(batch["gt_depth"].numpy(),
                                  pds.depths[1].reshape(-1)[inds])
    # no jitter: the reference draws it from its key inside render_rays
    tloss, tgrads, tout = ts.loss_and_grads(ts.state.params, ts.state.occ,
                                            batch, None)
    plain = ((tout["image"] - batch["gt"]) ** 2).mean(-1).mean()
    depth_term = ((tout["depth"] - batch["gt_depth"]) ** 2).mean()
    assert float(depth_term) > 0
    np.testing.assert_allclose(float(tloss), float(plain + depth_term),
                               rtol=1e-5)

    # the same batch through the reference's render and its loss expression
    occ = ts.state.occ
    with jax.disable_jit():   # eager, as the port: no FMA contraction
        jout = j_render_rays(
            js.state.params, jngp, js.fcfg, jnp.asarray(occ.bitfield.numpy()),
            jnp.asarray(batch["rays_o"].numpy()),
            jnp.asarray(batch["rays_d"].numpy()), js.opts,
            bg_color=jnp.ones((64, 3)), perturb=False,
            aabb=js._march_aabb(jnp.asarray(occ.occ_aabb.numpy())))
    per_ray = ((jout["image"] - jnp.asarray(batch["gt"].numpy())) ** 2) \
        .mean(-1) + (jout["depth"] - jnp.asarray(batch["gt_depth"].numpy())) ** 2
    np.testing.assert_allclose(float(tloss), float(per_ray.mean()), rtol=1e-4)
    assert all(float(g.abs().max()) > 0 for k, g in flatten_tree(tgrads))


def test_hacked_grid_updates_and_restore_grid():
    """tests/test_seal.py::test_teacher_opts_never_packed_and_restore_grid in
    the port: teacher options are never packed by default; the hacked refresh
    keeps the force-fill and widens the march AABB; restore_grid drops it."""
    ds = JScene().make_dataset(n_views=2, h=16, w=16, seed=0)
    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    fcfg = tngp.NGPConfig(bound=1.0, log2_hashmap_size=12, num_levels=2)
    # density_scale 0: the occupancy refresh provably clears everything
    opts = TOpts(bound=1.0, min_near=0.05, budget_per_ray=24,
                 num_candidates=96, max_steps=96, flat_frac=0.5,
                 density_scale=0.0)
    tcfg = TCfg(lr=1e-2, num_rays=128, eval_chunk=256, eval_budget_per_ray=32,
                eval_flat_frac=0.375, random_bg=False)
    st = tst.SealTrainer(
        tngp, fcfg, opts, tcfg, tmap.build_mapper(EDIT),
        teacher_params=tngp.init(fcfg, generator=torch.Generator()
                                 .manual_seed(0)),
        teacher_bitfield=torch.zeros(2**21 // 8, dtype=torch.uint8),
        dataset=tds, device="cpu")
    st.init_state()
    assert st._teacher_opts.flat_frac is None
    assert st._teacher_opts.budget_per_ray == 32
    assert int(np.unpackbits(st.teacher_bitfield.numpy()).sum()) > 0

    def bits():
        return int(np.unpackbits(st.state.occ.bitfield.numpy()).sum())

    st._apply_hack()
    hacked_bits = bits()
    assert hacked_bits > 0
    st.restore_grid()
    assert bits() == 0
    full, partial = st._grid_update_fns()
    full()
    assert bits() == hacked_bits
    aabb = st.state.occ.occ_aabb.numpy()
    ffb = st.mapper.force_fill_bound
    assert (aabb[:3] <= ffb[:, 0].min(0)).all()
    assert (aabb[3:] >= ffb[:, 1].max(0)).all()
    partial()
    assert bits() == hacked_bits
    # the probe seeds mean_count from a march over the hacked bitfield
    st._seed_mean_count_probe(n_views=2)
    assert float(st.state.occ.mean_count) > 0
    if not torch.cuda.is_available():   # device=None means the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tst.SealTrainer(tngp, fcfg, opts, tcfg, tmap.build_mapper(EDIT),
                            teacher_params=st.teacher_params,
                            teacher_bitfield=st.teacher_bitfield)
