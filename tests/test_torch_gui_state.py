"""Port parity of the GUI layer (seal3d_tpu_torch/gui/) against the JAX
package's seal3d_tpu/gui/state.py on the CPU, and the port's viewers driven
through a stub dearpygui.

The numpy parts (orbit camera, edit session, mask painter, depth lift,
texture rect, budget) take the same seeded inputs and moves in both
packages and give identical outputs. The controllers run side by side on
carried weights (JAX init -> params_from_jax, tables scaled up so the encode
drives the field, the analytic scene's occupancy; the `xla` backend, fp32 on
both sides; no training): the same stroke lifts to the same points within
1e-4 (XLA's FMA contraction under jit moves a position by an ulp), except at
most 2 rows where the MLPs' bf16 rounding flips between the packages (within
5e-2), and the configs and mappers built from them agree. The rest is the
port alone: a preview leaves the train rays as they were, the snapshot /
override / reset hold leaves bit for bit, the whole edit cycle, and
`--gui` through the CLIs.
"""

import contextlib
import dataclasses
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.gui import state as jgui
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.seal import mappers as jmap
from seal3d_tpu.train.trainer import TrainConfig as JCfg
from seal3d_tpu.train.trainer import Trainer as JTrainer
from seal3d_tpu_torch import gui as tgui_pkg
from seal3d_tpu_torch import main_nerf, main_SealNeRF
from seal3d_tpu_torch.config import common_parser
from seal3d_tpu_torch.data.provider import NeRFDataset
from seal3d_tpu_torch.gui import state as tgui
from seal3d_tpu_torch.gui import viewer as tviewer
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.seal import mappers as tmap
from seal3d_tpu_torch.train.checkpoint import flatten_tree, params_from_jax
from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
from seal3d_tpu_torch.train.trainer import Trainer as TTrainer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once. PyTorch's default
    of one intra-op thread per core in each of them oversubscribes the
    machine, and these CPU runs then take ten times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, num_candidates=256,
            coarse_steps=64, occ_stride=4, min_near=0.05)
TCFG = dict(eval_chunk=256, eval_budget_per_ray=48, eval_flat_frac=0.5,
            eval_two_level=True, eval_adaptive=True, eval_tile_chunks=True,
            num_rays=128)
NGP_KW = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
              grid_backend="xla", gridtype="hash")
# the stroke of tests/test_gui_state.py::test_seal_controller_full_cycle
CAM = dict(w=64, h=64, radius=2.2)
PAINT_RES = 16
PRETRAIN = dict(pretrain_epochs=1, pretrain_batch=4096,
                local_point_step=0.02, surrounding_point_step=0.06,
                global_point_step=0.15, local_angle_step=90.0,
                surrounding_angle_step=90.0, global_angle_step=90.0)


def _paint(ctl):
    ctl.session.state = ctl.session.state.__class__.BRUSH
    ctl.painter.radius = 2
    ctl.painter.drag(6, 8)
    ctl.painter.drag(10, 8)
    return ctl.finish_stroke()


@pytest.fixture(scope="module")
def scene():
    ds = JScene().make_dataset(n_views=2, h=24, w=24, seed=0)
    occ = occupancy_update(occupancy_init(cascades=1), JScene().density,
                           jax.random.PRNGKey(2), bound=1.0,
                           density_thresh=0.01, full=True)
    p = jngp.init(jax.random.PRNGKey(0), jngp.NGPConfig(**NGP_KW))
    p = dict(p, encoder=p["encoder"] * 5e3,
             encoder_color=p["encoder_color"] * 5e3)
    return ds, occ, jax.tree.map(np.asarray, p)


def _jax_teacher(scene):
    ds, occ, p = scene
    jtr = JTrainer(jngp, jngp.NGPConfig(**NGP_KW), JOpts(**OPTS),
                   JCfg(**TCFG), dataset=ds, key=jax.random.PRNGKey(0))
    jtr.init_state()
    jp = jax.tree.map(jax.numpy.asarray, p)
    jtr.state = jtr.state._replace(
        params=jp, ema_params=jp,
        occ=jtr.state.occ._replace(bitfield=occ.bitfield))
    return jtr


def _port_teacher(scene, workspace=None):
    ds, occ, p = scene
    tds = NeRFDataset(poses=ds.poses, images=ds.images,
                      intrinsics=ds.intrinsics, h=ds.h, w=ds.w)
    tr = TTrainer(tngp, tngp.NGPConfig(**NGP_KW), TOpts(**OPTS),
                  TCfg(**TCFG, workspace=workspace), dataset=tds,
                  device="cpu", name="gui_teacher")
    tr.init_state()
    # the grid count of a trained teacher, past its full-update phase: a
    # train slice's grid updates are partial ones
    tr.state = tr.state._replace(
        params=params_from_jax(p), ema_params=params_from_jax(p),
        occ=tr.state.occ._replace(
            bitfield=torch.from_numpy(np.array(occ.bitfield)),
            iter_density=torch.tensor(64, dtype=torch.int32)))
    return tr, tds


def _leaves(tree) -> dict:
    return {k: v.clone() for k, v in flatten_tree(tree)}


def _assert_leaves_equal(tree, want: dict):
    got = dict(flatten_tree(tree))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------------------ numpy parts

def _moves(rng, n=12):
    return [(("orbit", "pan", "scale")[int(rng.integers(3))],
             rng.uniform(-80, 80, 2)) for _ in range(n)]


def test_orbit_camera_matches_jax():
    """Pose and intrinsics after each of 12 seeded orbit, pan and scale
    moves, bit for bit."""
    rng = np.random.default_rng(0)
    for w, h, radius, fovy in ((800, 800, 3.0, 60.0), (640, 480, 2.2, 45.0)):
        jc, tc = (m.OrbitCamera(w, h, radius=radius, fovy=fovy)
                  for m in (jgui, tgui))
        for kind, (dx, dy) in _moves(rng):
            for c in (jc, tc):
                if kind == "scale":
                    c.scale(dx / 40.0)
                else:
                    getattr(c, kind)(dx, dy)
            np.testing.assert_array_equal(tc.pose, jc.pose)
            np.testing.assert_array_equal(tc.intrinsics, jc.intrinsics)
            np.testing.assert_array_equal(tc.intrinsics / 3, jc.intrinsics / 3)


def test_edit_session_configs_match_jax():
    """Brush configs (one and two strokes, with a normal, an rgb, a texture
    path) and anchor configs (2 and 3 plane clicks) equal as dicts, and
    reset returns both sessions to PREVIEW."""
    rng = np.random.default_rng(1)
    strokes = [rng.uniform(-0.3, 0.3, (n, 3)) for n in (25, 9)]
    clicks = rng.uniform(-0.3, 0.3, (4, 3))
    out = {}
    for name, m in (("jax", jgui), ("torch", tgui)):
        s = m.EditSession()
        s.paint(strokes[0])
        cfgs = [s.brush_config()]
        s.paint(strokes[1])
        s.rgb = [1.0, 0.2, 0.0]
        s.brush_pressure, s.attenuation_mode = 0.05, "dry"
        cfgs.append(s.brush_config(normal=[0, 1, 0]))
        s.texture_path = "tex.png"
        cfgs.append(s.brush_config())
        for k in (2, 3):
            a = m.EditSession()
            for c in clicks[:k + 1]:
                a.click_anchor(c)
            cfgs.append(a.anchor_config(radius=0.3, scale=(1, 2, 1)))
        s.reset()
        assert s.state is m.ToolState.PREVIEW and not s.brush_points
        out[name] = json.dumps(cfgs)
    assert out["torch"] == out["jax"]


def test_mask_painter_lift_and_texture_rect_match_jax():
    """Masks and indices after seeded drags (fast ones interpolate), the
    batch lift of those indices (misses and far hits dropped), the single
    depth lift and the texture rect config, all identical."""
    rng = np.random.default_rng(2)
    n = 48 * 40
    ro = rng.normal(size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    depth = rng.uniform(0, 3, n).astype(np.float32)
    depth[::7] = 0.0
    depth[::11] = 50.0
    drags = [rng.uniform(-4, 52, 2) for _ in range(9)]
    res = {}
    for name, m in (("jax", jgui), ("torch", tgui)):
        p = m.MaskPainter(40, 48, radius=3)
        for i, (x, y) in enumerate(drags):
            p.drag(x, y)
            if i == 4:
                p.release()
        p.release()
        idx = p.indices()
        res[name] = (p.mask.copy(), idx, m.lift_pixels(ro, rd, depth, idx),
                     m.depth_lift(ro, rd, depth),
                     m.texture_rect_config(ro[:3], "t.png", 0.1))
        p.clear()
        assert not p.any()
    for a, b in zip(res["torch"][:4], res["jax"][:4]):
        np.testing.assert_array_equal(a, b)
    assert res["torch"][4] == res["jax"][4]
    assert res["torch"][0].sum() > 50 and len(res["torch"][2]) > 0


def test_dynamic_budget_sequences_match_jax():
    """Downscale and train-step sequences under seeded preview and slice
    times, through every clamp, at the defaults and at other limits."""
    rng = np.random.default_rng(3)
    times = rng.choice([10.0, 90.0, 160.0, 400.0, 2500.0], 40)
    for kw in ({}, dict(preview_ms=150.0, train_ms=400.0)):
        seqs = []
        for m in (jgui, tgui):
            b = m.DynamicBudget(**kw)
            seq = [(b.downscale, b.train_steps)]
            for ms in times:
                b.update_preview(float(ms))
                b.update_train(float(ms) * 7)
                seq.append((b.downscale, b.train_steps))
            seqs.append(seq)
        assert seqs[1] == seqs[0]
        assert {d for d, _ in seqs[1]} == {1, 2, 3, 4}
        assert {4, 64} <= {n for _, n in seqs[1]}


# ------------------------------------------------- controllers side by side

def test_controller_lift_configs_and_mapper_match_jax(scene, tmp_path):
    """The same stroke through both controllers on carried weights: the
    lifted points, the brush and texture configs, and the brush mapper of
    the JAX controller's config built by both packages; the port's config
    builds a port mapper."""
    ds = scene[0]
    jtr = _jax_teacher(scene)
    ttr, tds = _port_teacher(scene)
    jc = jgui.SealController(jtr, jngp, jngp.NGPConfig(**NGP_KW), ds,
                             workspace=str(tmp_path / "j"),
                             cam=jgui.OrbitCamera(**CAM), paint_res=PAINT_RES)
    tc = tgui.SealController(ttr, tngp, ttr.fcfg, tds,
                             workspace=str(tmp_path / "t"),
                             cam=tgui.OrbitCamera(**CAM), paint_res=PAINT_RES)
    nj, nt = _paint(jc), _paint(tc)
    assert nt == nj > 16
    pj, pt = (np.concatenate(c.session.brush_points) for c in (jc, tc))
    off = np.abs(pt - pj).max(-1)
    assert (off > 1e-4).sum() <= 2 and off.max() <= 5e-2, off
    for c in (jc, tc):
        c.session.brush_pressure = 0.05
        c.session.rgb = [0.9, 0.1, 0.1]
    cj, ct = jc.session.brush_config(), tc.session.brush_config()
    assert {k: v for k, v in ct.items() if k != "raw"} == \
        {k: v for k, v in cj.items() if k != "raw"}
    np.testing.assert_allclose(ct["raw"], cj["raw"], atol=5e-2)
    assert jc.texture_config("t.png")["imageConfig"]["path"] == \
        tc.texture_config("t.png")["imageConfig"]["path"] == "t.png"

    jm = jmap.build_mapper(cj)
    tm = tmap.build_mapper(cj)
    assert tm.kind == jm.kind == "brush" and tm.flags == jm.flags
    for k, v in jm.data.items():
        np.testing.assert_allclose(tm.data[k].numpy(), np.asarray(v),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tm.force_fill_bound, jm.force_fill_bound,
                               atol=1e-6)
    own = tmap.build_mapper(ct)
    assert own.kind == "brush" and "rgb" in own.flags
    np.testing.assert_allclose(own.force_fill_bound, jm.force_fill_bound,
                               atol=5e-2)


# --------------------------------------------------------------- port only

def test_preview_leaves_the_train_rays(scene):
    """A preview and a lift at the camera's intrinsics (another fovy and
    size than the dataset's) leave the trainer's own: a train step's rays
    equal those of a trainer that never previewed, and the render equals
    one at the camera's intrinsics."""
    tr, tds = _port_teacher(scene)
    fresh, _ = _port_teacher(scene)
    ctl = tgui.SealController(tr, tngp, tr.fcfg, tds,
                              cam=tgui.OrbitCamera(40, 40, 2.5, fovy=35.0),
                              paint_res=8)
    ctl.budget.downscale = 2
    img, _ = ctl.render_frame(40, 40)
    assert img.shape == (20, 20, 3)
    ctl.painter.stamp(4, 4)
    assert len(ctl.lift_mask()) > 0
    np.testing.assert_array_equal(tr._intrinsics.numpy(), tds.intrinsics)
    rand = tr.draw_step_random()
    got, want = tr.sample_batch(rand), fresh.sample_batch(rand)
    for k in ("rays_o", "rays_d", "gt"):
        assert torch.equal(got[k], want[k]), k
    with tgui.camera_intrinsics(fresh, ctl.cam.intrinsics / 2):
        ref, _ = fresh.render_image(ctl.cam.pose, 20, 20)
    assert torch.equal(fresh._intrinsics,
                       torch.as_tensor(tds.intrinsics))
    np.testing.assert_array_equal(img, ref.numpy())
    with pytest.raises(ValueError, match="render failed"):
        with tgui.camera_intrinsics(tr, ctl.cam.intrinsics):
            raise ValueError("render failed")
    np.testing.assert_array_equal(tr._intrinsics.numpy(), tds.intrinsics)


def test_snapshot_override_and_reset_bit_exact(scene, tmp_path):
    """The snapshot is a clone: after the teacher trains on and a leaf is
    changed in place, reset restores every leaf of params and EMA bit for
    bit, and again after a second round. The override writes clones: the
    teacher holds the student's leaves, and a later in-place change of the
    student's leaves leaves the teacher's alone."""
    tr, tds = _port_teacher(scene, workspace=str(tmp_path))
    ctl = tgui.SealController(tr, tngp, tr.fcfg, tds,
                              workspace=str(tmp_path),
                              cam=tgui.OrbitCamera(**CAM),
                              paint_res=PAINT_RES)
    p0, e0 = _leaves(tr.state.params), _leaves(tr.state.ema_params)
    for _ in range(2):
        tr.train_step()
        tr.state.params["encoder"].add_(1.0)
        assert not torch.equal(tr.state.params["encoder"], p0["encoder"])
        ctl.reset_teacher()
        _assert_leaves_equal(tr.state.params, p0)
        _assert_leaves_equal(tr.state.ema_params, e0)
    assert _paint(ctl) > 0
    ctl.start_edit(ctl.session.brush_config(), **PRETRAIN)
    st = ctl.student
    _assert_leaves_equal(st.state.params, p0)       # starts at the teacher
    assert ctl.train_slice()
    sp, se = _leaves(st.state.params), _leaves(st.state.ema_params)
    assert not torch.equal(sp["encoder"], p0["encoder"])
    ctl.override_teacher()
    _assert_leaves_equal(tr.state.params, sp)
    _assert_leaves_equal(tr.state.ema_params, se)
    st.state.params["encoder"].add_(1.0)
    st.state.ema_params["encoder"].add_(1.0)
    _assert_leaves_equal(tr.state.params, sp)
    _assert_leaves_equal(tr.state.ema_params, se)
    ctl.reset_teacher()
    _assert_leaves_equal(tr.state.params, p0)
    _assert_leaves_equal(tr.state.ema_params, e0)


def test_seal_controller_full_cycle(scene, tmp_path):
    """tests/test_gui_state.py::test_seal_controller_full_cycle on the port:
    paint -> lift -> brush config -> start edit -> a pretraining slice
    (which ends the one-epoch pretraining) -> a finetune slice (proxied
    dataset with depths, stage 2 set up, the budget's steps) -> pretrain-only
    caps a new edit -> a time limit caps it -> save -> override -> reset.
    The teacher's train config stays untouched by stage 2."""
    tr, tds = _port_teacher(scene, workspace=str(tmp_path))
    orig = tr.state.params["encoder"].clone()
    ctl = tgui.SealController(tr, tngp, tr.fcfg, tds,
                              workspace=str(tmp_path),
                              cam=tgui.OrbitCamera(**CAM),
                              paint_res=PAINT_RES)
    assert not ctl.train_slice()        # nothing to train before an edit
    n_lifted = _paint(ctl)
    assert n_lifted > 0 and not ctl.painter.any()
    ctl.session.brush_pressure = 0.05
    cfg = ctl.session.brush_config(normal=None)
    assert cfg["type"] == "brush" and len(cfg["raw"]) == n_lifted
    ctl.start_edit(cfg, **PRETRAIN)
    st = ctl.student
    assert st is not None and ctl.session.state is tgui.ToolState.TRAIN
    assert ctl.render_trainer is st and st.device == tr.device
    assert st.is_pretraining
    assert ctl.train_slice()
    assert not st.is_pretraining and len(st.pretrain_losses) == 1
    assert st.dataset.depths is None
    img, _ = ctl.render_frame(64, 64)
    assert np.isfinite(img).all()
    ctl.budget.train_steps = 4
    assert ctl.train_slice()
    assert int(st.state.step) == 4 and st.dataset.depths is not None
    assert st.cfg.retune_warm and not tr.cfg.retune_warm
    assert 4 <= ctl.budget.train_steps <= 64
    path = ctl.save_checkpoint()
    assert "gui_student" in path

    student_param = st.state.params["encoder"].clone()
    ctl.override_teacher()
    assert ctl.student is None and ctl.session.state is tgui.ToolState.PREVIEW
    assert torch.equal(tr.state.params["encoder"], student_param)
    ctl.reset_teacher()
    assert torch.equal(tr.state.params["encoder"], orig)

    # pretrain-only: pretraining finished, no finetune slice
    _paint(ctl)
    ctl.start_edit(ctl.session.brush_config(), **PRETRAIN)
    ctl.pretrain_only = True
    assert ctl.train_slice() and not ctl.student.is_pretraining
    assert not ctl.train_slice()
    assert int(ctl.student.state.step) == 0
    ctl.pretrain_only, ctl.time_limit = False, 0.0
    assert not ctl.train_slice()


# -------------------------------------------------------- viewers, launch

class _StubDPG(types.ModuleType):
    """dearpygui.dearpygui's calls that the viewers make, recording
    callbacks by label; `render_dearpygui_frame` runs the next scripted
    action, and the loop ends after the script."""

    mvFormat_Float_rgb, mvMouseButton_Left, mvMouseButton_Middle = 0, 0, 2

    def __init__(self, script):
        super().__init__("dearpygui.dearpygui")
        self.script, self.frame = list(script), 0
        self.callbacks, self.handlers, self.values = {}, {}, {}
        self.mouse = (0.0, 0.0)
        for name in ("create_context", "destroy_context", "create_viewport",
                     "setup_dearpygui", "set_primary_window", "show_viewport",
                     "add_raw_texture", "add_image"):
            setattr(self, name, lambda *a, **k: None)
        for name in ("texture_registry", "window", "handler_registry",
                     "group"):
            setattr(self, name, lambda *a, **k: contextlib.nullcontext())
        for name in ("add_checkbox", "add_slider_float", "add_button",
                     "add_combo", "add_color_edit", "add_input_float"):
            setattr(self, name, self._item)

    def _item(self, *args, label=None, callback=None, **kw):
        self.callbacks[label] = callback

    def add_mouse_drag_handler(self, button, callback):
        self.handlers[("drag", button)] = callback

    def add_mouse_wheel_handler(self, callback):
        self.handlers["wheel"] = callback

    def add_mouse_release_handler(self, button, callback):
        self.handlers[("release", button)] = callback

    def get_mouse_pos(self, local=False):
        return self.mouse

    def set_value(self, tag, value):
        self.values[tag] = np.array(value)

    def is_dearpygui_running(self):
        return self.frame < len(self.script)

    def render_dearpygui_frame(self):
        self.script[self.frame](self)
        self.frame += 1


def _install(monkeypatch, script):
    dpg = _StubDPG(script)
    pkg = types.ModuleType("dearpygui")
    pkg.dearpygui = dpg
    monkeypatch.setitem(sys.modules, "dearpygui", pkg)
    monkeypatch.setitem(sys.modules, "dearpygui.dearpygui", dpg)
    return dpg


def test_nerf_viewer_render_through_stub_dpg(scene, monkeypatch):
    """launch_gui -> NeRFViewer.render(): frames at the budget's downscale
    (also 3, which does not divide the window: the last row and column
    repeat to its edge), the orbit, wheel and pan handlers move the camera,
    the train checkbox turns on training slices; without dearpygui
    launch_gui raises."""
    tr, _ = _port_teacher(scene)
    args = common_parser("t").parse_args(
        ["synthetic", "--device", "cpu", "--H", "32", "--W", "32",
         "--radius", "2.2", "--test"])
    with pytest.raises(RuntimeError, match="dearpygui"):
        tgui_pkg.launch_gui(args, tr)
    seen = {}

    def move(d):
        pose = seen.setdefault("pose", d.viewer.cam.pose.copy())
        d.handlers[("drag", d.mvMouseButton_Left)](None, (0, 30.0, 10.0))
        d.handlers["wheel"](None, 1.0)
        d.handlers[("drag", d.mvMouseButton_Middle)](None, (0, 5.0, 5.0))
        assert not np.array_equal(d.viewer.cam.pose, pose)
        d.viewer.budget.downscale = 3

    def train_on(d):
        seen["img3"] = d.values["_tex"].reshape(32, 32, 3).copy()
        d.callbacks["train"](None, True)
        d.viewer.budget.train_steps = 2

    dpg = _install(monkeypatch, [move, train_on, lambda d: None])
    made = []
    real = tviewer.NeRFViewer.__init__

    def init(self, *a):
        real(self, *a)
        dpg.viewer = self
        made.append(self)

    monkeypatch.setattr(tviewer.NeRFViewer, "__init__", init)
    monkeypatch.setattr(tgui_pkg, "HAS_DPG", True)
    step0 = int(tr.state.step)
    tgui_pkg.launch_gui(args, tr)
    assert dpg.frame == 3 and made[0].training
    img3 = seen["img3"]
    assert np.isfinite(img3).all()
    np.testing.assert_array_equal(img3[30:], np.repeat(img3[29:30], 2, 0))
    np.testing.assert_array_equal(img3[:, 30:], np.repeat(img3[:, 29:30], 2, 1))
    assert int(tr.state.step) == step0 + 2


def test_seal_viewer_render_through_stub_dpg(tmp_path, monkeypatch, capsys):
    """SealViewer on the Seal CLI's arguments: the teacher loads from
    --teacher_ckpt as main_SealNeRF's does; through the dpg loop a brush
    drag and release lift a stroke, 'start' pretrains at the CLI's recipe
    (one epoch; 'pretrain only' then holds the loop's slices), the mesh
    export writes meshes/gui.ply, 'override' commits and 'reset' restores
    the teacher."""
    tws, ws = str(tmp_path / "tws"), str(tmp_path / "ws")
    argv = ["synthetic", "--device", "cpu", "--bound", "1.0", "--dt_gamma",
            "0", "--min_near", "0.05", "--max_steps", "256", "--H", "24",
            "--W", "24", "--radius", "2.2", "--num_views", "2",
            "--grid_backend", "xla", "--log2_hashmap_size", "12",
            "--num_rays", "128", "--seal_config", "unused",
            "--teacher_workspace", tws, "--workspace", ws,
            "--pretraining_epochs", "1", "--pretraining_batch_size", "4096",
            "--pretraining_local_point_step", "0.02",
            "--pretraining_surrounding_point_step", "0.06",
            "--pretraining_global_point_step", "0.15"]
    args = main_SealNeRF.add_seal_args(common_parser("t")).parse_args(argv)
    seen = {}

    def make_trainer(tcfg, ds, name):
        tcfg = dataclasses.replace(tcfg, eval_chunk=256)
        return TTrainer(tngp, fcfg, TOpts(**OPTS), tcfg, dataset=ds,
                        device="cpu", name=name)

    fcfg = tngp.NGPConfig(**NGP_KW)
    # the teacher checkpoint: the analytic occupancy, tables scaled up
    from seal3d_tpu_torch.config import load_dataset
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.render.occupancy import (occupancy_init as t_init,
                                                   occupancy_update as t_upd)

    teacher = make_trainer(TCfg(workspace=tws), load_dataset(args),
                           "sealnerf_teacher")
    teacher.init_state()
    p = dict(teacher.state.params)
    p["encoder"], p["encoder_color"] = (p["encoder"] * 5e3,
                                        p["encoder_color"] * 5e3)
    occ = t_upd(t_init(1), SyntheticScene().density, 1.0,
                density_thresh=0.01, full=True,
                generator=torch.Generator().manual_seed(2))
    teacher.state = teacher.state._replace(params=p, ema_params=p, occ=occ)
    ckpt = teacher.save_checkpoint()

    def brush(d):
        v = d.viewer
        seen["teacher"] = _leaves(v.trainer.state.params)
        d.callbacks["brush"](None, None)
        for x in (9.0, 12.0, 15.0):
            d.mouse = (x, 12.0)
            d.handlers[("drag", d.mvMouseButton_Left)](None, (0, 0, 0))
        d.handlers[("release", d.mvMouseButton_Left)](None, None)
        assert v.session.brush_points and not v.ctl.painter.any()

    def start(d):
        d.callbacks["start"]()
        assert d.viewer.session.state is tgui.ToolState.TRAIN

    def after_pretrain(d):
        assert not d.viewer.student.is_pretraining
        d.callbacks["pretrain only"](None, True)

    def finish(d):
        v = d.viewer
        assert int(v.student.state.step) == 0    # pretrain-only: no finetune
        v._export_mesh(resolution=24)
        sp = _leaves(v.student.state.params)
        d.callbacks["override"]()
        _assert_leaves_equal(v.trainer.state.params, sp)
        d.callbacks["reset"]()
        _assert_leaves_equal(v.trainer.state.params, seen["teacher"])

    dpg = _install(monkeypatch, [brush, start, after_pretrain,
                                 lambda d: None, finish])
    real = tviewer.SealViewer.__init__

    def init(self, *a):
        real(self, *a)
        dpg.viewer = self

    monkeypatch.setattr(tviewer.SealViewer, "__init__", init)
    monkeypatch.setattr(tgui_pkg, "HAS_DPG", True)
    args.teacher_ckpt = ckpt
    tgui_pkg.launch_seal_gui(args, tngp, fcfg, make_trainer)
    out = capsys.readouterr().out
    assert f"[teacher] loaded {ckpt}" in out and "[gui] stroke lifted to" in out
    assert dpg.frame == 5 and "_tex" in dpg.values
    assert (tmp_path / "ws" / "meshes" / "gui.ply").exists()


def test_gui_through_main_nerf_needs_dearpygui(tmp_path):
    """main_nerf --gui reaches launch_gui after the checkpoint load and
    before any step: without dearpygui, the RuntimeError naming it."""
    with pytest.raises(RuntimeError, match="dearpygui"):
        main_nerf.main(["synthetic", "-O", "--device", "cpu", "--bound",
                        "1.0", "--H", "16", "--W", "16", "--num_views", "2",
                        "--log2_hashmap_size", "12", "--workspace",
                        str(tmp_path), "--gui"])
    assert not (tmp_path / "checkpoints").exists()
