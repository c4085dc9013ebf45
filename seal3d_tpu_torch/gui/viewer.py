"""dearpygui viewers over the port's trainers (port of
seal3d_tpu/gui/viewer.py; the logic is in gui/state.py).

NeRFViewer: orbit view + live training time-slicing (reference nerf/gui.py),
with a time slider over a D-NeRF trainer (reference dnerf/gui.py).
SealViewer: PREVIEW/BRUSH/TEXTURE/ANCHOR/TRAIN editing states with 2D mask
painting lifted to 3D via depth, teacher/student render switching, pretrain-
only and wall-clock budget toggles (reference SealNeRF/gui.py:91-1240).

dearpygui is imported by `render()` alone, so everything but the display
loop runs headless. Previews render at the camera's intrinsics without
leaving them on the trainer (`state.camera_intrinsics`)."""

from __future__ import annotations

import os
import time

import numpy as np

from seal3d_tpu_torch.gui.state import (DynamicBudget, OrbitCamera,
                                        SealController, ToolState,
                                        camera_intrinsics)


class NeRFViewer:
    def __init__(self, args, trainer):
        self.args = args
        self.trainer = trainer
        self.cam = OrbitCamera(args.W, args.H, radius=args.radius,
                               fovy=args.fovy)
        self.budget = DynamicBudget()
        self.training = not args.test
        self.buffer = np.zeros((args.H, args.W, 3), np.float32)
        # D-NeRF trainers expose render_image_t; the viewer then shows a
        # time slider (reference dnerf/gui.py).
        self.time_value = 0.0
        self._time_aware = hasattr(trainer, "render_image_t")
        self._dpg = None    # the dearpygui module while render() runs

    def _fill(self, img: np.ndarray, ds: int):
        """The window buffer from a preview at 1/ds of its size: each pixel
        repeated ds times each way; where ds does not divide the window the
        last row and column repeat to its edge."""
        img = np.repeat(np.repeat(img, ds, 0), ds, 1)
        h, w = self.buffer.shape[:2]
        self.buffer[:] = np.pad(img, ((0, h - img.shape[0]),
                                      (0, w - img.shape[1]), (0, 0)),
                                mode="edge")

    # one preview frame at the adaptive resolution
    def render_frame(self):
        t0 = time.time()
        ds = self.budget.downscale
        h, w = self.args.H // ds, self.args.W // ds
        with camera_intrinsics(self.trainer, self.cam.intrinsics / ds):
            if self._time_aware:
                img, _ = self.trainer.render_image_t(self.cam.pose, h, w,
                                                     float(self.time_value))
            else:
                img, _ = self.trainer.render_image(self.cam.pose, h, w)
        img = img.cpu().numpy()
        self.budget.update_preview((time.time() - t0) * 1000)
        self._fill(img, ds)
        return self.buffer

    def train_slice(self):
        t0 = time.time()
        n = self.budget.train_steps
        self.trainer.train(steps=n, log_every=n + 1)  # logs first and last
        self.budget.update_train((time.time() - t0) * 1000)

    def render(self):
        import dearpygui.dearpygui as dpg

        self._dpg = dpg
        dpg.create_context()
        with dpg.texture_registry():
            dpg.add_raw_texture(self.args.W, self.args.H,
                                self.buffer.reshape(-1), format=dpg.mvFormat_Float_rgb,
                                tag="_tex")
        with dpg.window(tag="_primary"):
            dpg.add_image("_tex")
            dpg.add_checkbox(label="train", default_value=self.training,
                             callback=lambda s, v: setattr(self, "training", v))
            if self._time_aware:
                dpg.add_slider_float(label="time", min_value=0.0, max_value=1.0,
                                     callback=lambda s, v: setattr(
                                         self, "time_value", v))
        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(
                button=dpg.mvMouseButton_Left,
                callback=lambda s, d: self.cam.orbit(d[1], d[2]))
            dpg.add_mouse_wheel_handler(
                callback=lambda s, d: self.cam.scale(d))
            dpg.add_mouse_drag_handler(
                button=dpg.mvMouseButton_Middle,
                callback=lambda s, d: self.cam.pan(d[1], d[2]))
        dpg.create_viewport(title="seal3d-tpu", width=self.args.W,
                            height=self.args.H + 60)
        dpg.setup_dearpygui()
        dpg.set_primary_window("_primary", True)
        dpg.show_viewport()
        last_preview = 0.0
        while dpg.is_dearpygui_running():
            if self.training:
                self.train_slice()
            if time.time() - last_preview > 0.5 or not self.training:
                self.render_frame()
                dpg.set_value("_tex", self.buffer.reshape(-1))
                last_preview = time.time()
            dpg.render_dearpygui_frame()
        dpg.destroy_context()


class SealViewer(NeRFViewer):
    """Thin dpg shell over SealController (all interaction logic is headless
    in gui/state.py). Buttons/handlers mirror the reference editing GUI:
    tool states + drag-paint (SealNeRF/gui.py:1111-1158), config/start
    (:453-505, 672-691), texture rect (:809-829), save/override/reset
    (:532-576), pretrain-only + time limit (:511-521).

    The teacher is main_SealNeRF's (`build_teacher`: `--teacher_workspace`,
    `--teacher_ckpt`, `--train_teacher`), an edit pretrains at the CLI's
    `--pretraining_*` recipe, and previews and train slices share the
    controller's budget."""

    def __init__(self, args, field_mod, fcfg, make_trainer):
        from seal3d_tpu_torch.config import load_dataset
        from seal3d_tpu_torch.main_SealNeRF import build_teacher

        ds = load_dataset(args, "trainval", device=args.device)
        teacher = build_teacher(args, fcfg, make_trainer, "sealnerf", ds)
        super().__init__(args, teacher)
        self.ctl = SealController(teacher, field_mod, fcfg, ds,
                                  workspace=args.workspace, cam=self.cam,
                                  seed=args.seed + 1)
        self.budget = self.ctl.budget
        self.texture_path = getattr(args, "texture_path", None)
        self.pretrain_kw = dict(
            pretrain_epochs=args.pretraining_epochs,
            pretrain_batch=args.pretraining_batch_size,
            lr=args.pretraining_lr,
            local_point_step=args.pretraining_local_point_step,
            surrounding_point_step=args.pretraining_surrounding_point_step,
            global_point_step=args.pretraining_global_point_step)

    # compat passthroughs (tests/round-1 callers)
    @property
    def session(self):
        return self.ctl.session

    @property
    def student(self):
        return self.ctl.student

    @property
    def render_trainer(self):
        return self.ctl.render_trainer

    def pick_surface(self, px: int, py: int):
        """Single-pixel depth lift (kept for anchor clicks; mask painting
        uses the batched ctl.finish_stroke path)."""
        r = self.ctl.paint_res
        self.ctl.painter.clear()
        self.ctl.painter.radius = 0.5
        self.ctl.painter.stamp(px * r / self.args.W, py * r / self.args.H)
        pts = self.ctl.lift_mask()
        self.ctl.painter.clear()
        self.ctl.painter.radius = 6
        return pts[0] if len(pts) else None

    def start_edit(self, config: dict):
        self.ctl.start_edit(config, **self.pretrain_kw)

    def train_slice(self):
        self.ctl.train_slice()

    def override_teacher(self):
        self.ctl.override_teacher()

    def render_frame(self):
        ds = self.budget.downscale
        img, _ = self.ctl.render_frame(self.args.H, self.args.W)
        self._fill(img, ds)
        return self.buffer

    # --------------------------------------------------------- dpg bindings
    def _on_drag(self, sender, data):
        if self.session.state is ToolState.BRUSH:
            x, y = self._dpg.get_mouse_pos(local=False)
            r = self.ctl.paint_res
            self.ctl.painter.drag(x * r / self.args.W, y * r / self.args.H)
        else:
            self.cam.orbit(data[1], data[2])

    def _on_release(self, sender, data):
        if self.session.state is ToolState.BRUSH:
            n = self.ctl.finish_stroke()
            print(f"[gui] stroke lifted to {n} surface points")

    def _export_mesh(self, resolution: int = 192):
        """Marching-tetrahedra export of the active model's EMA density to
        `<workspace>/meshes/gui.ply` (reference mesh button, nerf/gui.py
        save_mesh callback) -> (verts, tris)."""
        from seal3d_tpu_torch.runtime.mesh_export import (extract_geometry,
                                                          save_mesh)

        tr = self.render_trainer
        verts, tris = extract_geometry(
            lambda x: self.ctl.field_mod.density(
                tr.state.ema_params, self.ctl.fcfg, x)["sigma"],
            bound=self.args.bound, resolution=resolution,
            threshold=min(10.0, float(tr.state.occ.mean_density)),
            device=tr.device)
        path = os.path.join(self.args.workspace, "meshes", "gui.ply")
        save_mesh(path, verts, tris)
        print(f"[gui] mesh {len(verts)} verts -> {path}")
        return verts, tris

    def _config_and_start(self):
        s = self.session
        if s.state is ToolState.TEXTURE and self.texture_path:
            cfg = self.ctl.texture_config(self.texture_path)
        elif s.anchor_points:
            cfg = s.anchor_config()
        else:
            cfg = s.brush_config()
        self.start_edit(cfg)

    def render(self):
        import dearpygui.dearpygui as dpg

        self._dpg = dpg
        dpg.create_context()
        with dpg.texture_registry():
            dpg.add_raw_texture(self.args.W, self.args.H,
                                self.buffer.reshape(-1),
                                format=dpg.mvFormat_Float_rgb, tag="_tex")
        with dpg.window(tag="_primary"):
            dpg.add_image("_tex")
            with dpg.group(horizontal=True):
                for tool in (ToolState.PREVIEW, ToolState.BRUSH,
                             ToolState.TEXTURE, ToolState.ANCHOR):
                    dpg.add_button(
                        label=tool.value,
                        callback=lambda s, a, t=tool: setattr(
                            self.session, "state", t))
            with dpg.group(horizontal=True):
                dpg.add_button(label="start",
                               callback=lambda: self._config_and_start())
                dpg.add_button(label="save",
                               callback=lambda: self.ctl.save_checkpoint())
                dpg.add_button(label="override",
                               callback=lambda: self.ctl.override_teacher())
                dpg.add_button(label="reset",
                               callback=lambda: self.ctl.reset_teacher())
            # brush parameters (reference sliders, SealNeRF/gui.py:692-760)
            with dpg.group(horizontal=True):
                dpg.add_slider_float(
                    label="pressure", default_value=self.session.brush_pressure,
                    min_value=0.0, max_value=0.2, width=120,
                    callback=lambda s, v: setattr(
                        self.session, "brush_pressure", v))
                dpg.add_slider_float(
                    label="depth", default_value=self.session.brush_depth,
                    min_value=0.0, max_value=2.0, width=120,
                    callback=lambda s, v: setattr(
                        self.session, "brush_depth", v))
            with dpg.group(horizontal=True):
                dpg.add_slider_float(
                    label="attenuation",
                    default_value=self.session.attenuation_distance,
                    min_value=0.0, max_value=0.2, width=120,
                    callback=lambda s, v: setattr(
                        self.session, "attenuation_distance", v))
                dpg.add_combo(("linear", "dry"), label="mode",
                              default_value=self.session.attenuation_mode,
                              width=80,
                              callback=lambda s, v: setattr(
                                  self.session, "attenuation_mode", v))
            # recolor picker (rgb edits, reference gui.py:762-790); alpha
            # toggles whether the edit carries a color at all
            dpg.add_color_edit(label="edit color", default_value=(255, 0, 0, 0),
                               callback=lambda s, v: setattr(
                                   self.session, "rgb",
                                   [v[0], v[1], v[2]] if v[3] > 0 else None))
            dpg.add_button(label="export mesh",
                           callback=lambda: self._export_mesh())
            dpg.add_checkbox(label="show student",
                             callback=lambda s, v: setattr(
                                 self.ctl, "show_student", v))
            dpg.add_checkbox(label="pretrain only",
                             callback=lambda s, v: setattr(
                                 self.ctl, "pretrain_only", v))
            dpg.add_input_float(label="time limit (s)", default_value=0.0,
                                callback=lambda s, v: setattr(
                                    self.ctl, "time_limit", v or None))
            if hasattr(self.trainer, "render_image_t"):
                dpg.add_slider_float(label="time", min_value=0.0,
                                     max_value=1.0,
                                     callback=lambda s, v: setattr(
                                         self.ctl, "time_value", v))
        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                       callback=self._on_drag)
            dpg.add_mouse_release_handler(button=dpg.mvMouseButton_Left,
                                          callback=self._on_release)
            dpg.add_mouse_wheel_handler(callback=lambda s, d: self.cam.scale(d))
            dpg.add_mouse_drag_handler(
                button=dpg.mvMouseButton_Middle,
                callback=lambda s, d: self.cam.pan(d[1], d[2]))
        dpg.create_viewport(title="seal3d-tpu edit", width=self.args.W,
                            height=self.args.H + 180)
        dpg.setup_dearpygui()
        dpg.set_primary_window("_primary", True)
        dpg.show_viewport()
        last_preview = 0.0
        while dpg.is_dearpygui_running():
            if self.session.state is ToolState.TRAIN:
                self.ctl.train_slice()
            if time.time() - last_preview > 0.5:
                self.render_frame()
                dpg.set_value("_tex", self.buffer.reshape(-1))
                last_preview = time.time()
            dpg.render_dearpygui_frame()
        dpg.destroy_context()
