"""Headless GUI state (port of seal3d_tpu/gui/state.py): the orbit camera,
the edit-tool state machine, the mask painter and its depth lift, the
interactivity budget, and `SealController`, the whole edit interaction
without a display.

The numpy parts are the reference's code and give its numbers bit for bit.
The controller differs from the JAX one where a line-by-line port would be
wrong in PyTorch or where the JAX controller leaves the edit unfinished:
- a preview or a lift renders with the camera's intrinsics and restores the
  trainer's own afterwards (`camera_intrinsics`): the port's train step and
  teacher views read `Trainer._intrinsics` eagerly, where a compiled JAX
  step keeps the dataset's;
- the teacher snapshot, the override and the reset write clones: a torch
  tensor can change in place and the student's teacher params share the
  teacher's storage;
- the student starts from the teacher's params and occupancy (as the
  reference's student loads the teacher's checkpoint, and as `train_edit`
  starts), its pretraining ends after `epochs` epochs, and its first
  finetune slice proxies the dataset through the mapped teacher and starts
  stage 2 as `train_edit` does. The JAX controller keeps a random-init
  student pretraining until a caller flips `is_pretraining`, then
  finetunes it on the unedited images.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

import numpy as np
import torch


class ToolState(Enum):
    PREVIEW = "preview"
    BRUSH = "brush"
    TEXTURE = "texture"
    ANCHOR = "anchor"
    TRAIN = "train"


class OrbitCamera:
    """Reference OrbitCamera (nerf/gui.py:10-53): radius/center orbit with
    +z-forward ngp pose convention."""

    def __init__(self, w: int, h: int, radius: float = 2.0, fovy: float = 60.0):
        self.w, self.h = w, h
        self.radius = radius
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3, dtype=np.float32)

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.h / (2.0 * np.tan(np.radians(self.fovy) / 2.0))
        return np.array([focal, focal, self.w / 2, self.h / 2], np.float32)

    @property
    def pose(self) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.rot
        pose[:3, 3] = self.center - self.rot @ np.array([0, 0, self.radius],
                                                        np.float32)
        return pose

    def orbit(self, dx: float, dy: float, speed: float = 0.005):
        def rot_axis(axis, angle):
            axis = axis / (np.linalg.norm(axis) + 1e-9)
            k = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]], np.float32)
            return np.eye(3, dtype=np.float32) + np.sin(angle) * k + \
                (1 - np.cos(angle)) * (k @ k)

        up = self.rot[:, 1]
        side = self.rot[:, 0]
        self.rot = rot_axis(up, -dx * speed) @ rot_axis(side, -dy * speed) @ self.rot

    def pan(self, dx: float, dy: float, speed: float = 0.001):
        self.center += speed * self.rot @ np.array([-dx, -dy, 0], np.float32)

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)


def depth_lift(rays_o: np.ndarray, rays_d: np.ndarray,
               depth: np.ndarray) -> np.ndarray:
    """Lift 2D pixels to 3D surface points via rendered depth
    (reference get_mask_pos: pos = rays_o + depth * rays_d,
    SealNeRF/gui.py:300-306 / nerf/utils.py:799)."""
    return rays_o + depth[..., None] * rays_d


@dataclass
class EditSession:
    """Accumulates tool interactions into a seal.json-style config dict."""

    state: ToolState = ToolState.PREVIEW
    brush_points: List[np.ndarray] = field(default_factory=list)
    anchor_points: List[np.ndarray] = field(default_factory=list)
    brush_pressure: float = 0.02
    brush_depth: float = 1.0
    attenuation_distance: float = 0.02
    attenuation_mode: str = "linear"
    rgb: Optional[List[float]] = None
    texture_path: Optional[str] = None

    def paint(self, surface_points: np.ndarray):
        self.brush_points.append(np.asarray(surface_points, np.float32))

    def click_anchor(self, point: np.ndarray):
        self.anchor_points.append(np.asarray(point, np.float32))

    def brush_config(self, normal=None) -> dict:
        """Reference brush config builder (SealNeRF/gui.py:672-691)."""
        assert self.brush_points, "paint first"
        cfg = {
            "type": "brush",
            "raw": [p.tolist() for p in self.brush_points]
            if len(self.brush_points) > 1 else self.brush_points[0].tolist(),
            "brushType": "line",
            "brushPressure": self.brush_pressure,
            "brushDepth": self.brush_depth,
            "attenuationDistance": self.attenuation_distance,
            "attenuationMode": self.attenuation_mode,
        }
        if normal is not None:
            cfg["normal"] = list(normal)
        if self.rgb is not None:
            cfg["rgb"] = list(self.rgb)
        if self.texture_path is not None:
            cfg["imageConfig"] = {"path": self.texture_path}
        return cfg

    def anchor_config(self, radius: float = 0.2, scale=(1, 1, 1)) -> dict:
        """Reference anchor 3-click + direction flow (SealNeRF/gui.py:851-903):
        first clicks define the plane/anchor, the last the translation tip."""
        assert len(self.anchor_points) >= 2, "need >= 2 anchor clicks"
        plane_pts = np.stack(self.anchor_points[:-1])
        if len(plane_pts) < 3:  # pad plane definition around the anchor
            jitter = np.array([[0.01, 0, 0], [0, 0.01, 0]], np.float32)
            plane_pts = np.concatenate([plane_pts,
                                        plane_pts[:1] + jitter[: 3 - len(plane_pts)]])
        anchor = plane_pts.mean(0)
        tip = self.anchor_points[-1]
        cfg = {
            "type": "anchor",
            "raw": plane_pts.tolist(),
            "translation": (tip - anchor).tolist(),
            "radius": radius,
            "scale": list(scale),
        }
        if self.rgb is not None:
            cfg["rgb"] = list(self.rgb)
        return cfg

    def reset(self):
        self.brush_points.clear()
        self.anchor_points.clear()
        self.state = ToolState.PREVIEW


class MaskPainter:
    """2D drag-painted mask canvas (reference paints per-pixel masks during
    mouse drag, SealNeRF/gui.py:1111-1158). Strokes are circles of `radius`
    pixels stamped along the drag path; `indices()` yields the flat pixel ids
    for the batch depth lift."""

    def __init__(self, h: int, w: int, radius: int = 6):
        self.h, self.w = h, w
        self.radius = radius
        self.mask = np.zeros((h, w), bool)
        self._last = None

    def stamp(self, px: float, py: float):
        r = self.radius
        x0, x1 = max(int(px - r), 0), min(int(px + r) + 1, self.w)
        y0, y1 = max(int(py - r), 0), min(int(py + r) + 1, self.h)
        if x0 >= x1 or y0 >= y1:
            return
        yy, xx = np.mgrid[y0:y1, x0:x1]
        self.mask[y0:y1, x0:x1] |= (xx - px) ** 2 + (yy - py) ** 2 <= r * r

    def drag(self, px: float, py: float):
        """Stamp along the segment from the previous drag point (so fast
        drags leave no gaps)."""
        if self._last is not None:
            lx, ly = self._last
            dist = float(np.hypot(px - lx, py - ly))
            n = max(int(dist / max(self.radius * 0.5, 1)), 1)
            for t in np.linspace(0, 1, n + 1)[1:]:
                self.stamp(lx + (px - lx) * t, ly + (py - ly) * t)
        else:
            self.stamp(px, py)
        self._last = (px, py)

    def release(self):
        self._last = None

    def indices(self) -> np.ndarray:
        """Flat (row-major) pixel indices of the painted mask."""
        return np.flatnonzero(self.mask.reshape(-1))

    def any(self) -> bool:
        return bool(self.mask.any())

    def clear(self):
        self.mask[:] = False
        self._last = None


def lift_pixels(rays_o: np.ndarray, rays_d: np.ndarray, depth: np.ndarray,
                indices: np.ndarray, max_depth: float = 10.0) -> np.ndarray:
    """Batch depth lift of masked pixels to 3D surface points (the whole-mask
    analog of reference get_mask_pos, SealNeRF/gui.py:300-306; pixels whose
    rays hit nothing — depth ~0 or huge — are dropped)."""
    ro = np.asarray(rays_o).reshape(-1, 3)[indices]
    rd = np.asarray(rays_d).reshape(-1, 3)[indices]
    d = np.asarray(depth).reshape(-1)[indices]
    ok = (d > 1e-3) & (d < max_depth)
    return (ro + d[:, None] * rd)[ok].astype(np.float32)


def texture_rect_config(corners: np.ndarray, image_path: str,
                        rgb_light_offset: float = 0.0) -> dict:
    """imageConfig from a screen-rect's three lifted 3D corners
    (o = top-left, w = top-right, h = bottom-left — reference texture tool,
    SealNeRF/gui.py:809-829)."""
    c = np.asarray(corners, np.float32)
    assert c.shape == (3, 3), "need [o, w, h] corners"
    return {
        "path": image_path,
        "o": c[0].tolist(),
        "w": c[1].tolist(),
        "h": c[2].tolist(),
        "rgbLightOffset": rgb_light_offset,
    }


@contextlib.contextmanager
def camera_intrinsics(trainer, intrinsics):
    """Render through `trainer` with a GUI camera's intrinsics [4]; its own
    (the dataset's, which its train steps and teacher views read) come back
    on exit, also when the render raises."""
    saved = trainer._intrinsics
    trainer._intrinsics = torch.as_tensor(
        np.asarray(intrinsics, np.float32), device=trainer.device)
    try:
        yield
    finally:
        trainer._intrinsics = saved


def _clone_tree(tree):
    from seal3d_tpu_torch.train.checkpoint import map_tree

    return map_tree(tree, lambda _, t: t.detach().clone())


class SealController:
    """Headless editing controller: the full interaction surface of the
    reference Seal GUI (SealNeRF/gui.py) minus the dearpygui shell —
    drag-paint masks lifted to 3D, brush/texture/anchor config building,
    start-edit, interleaved train slices, checkpoint save / teacher override /
    reset, pretrain-only and wall-clock limits, and a D-NeRF time slider.
    `gui/viewer.py` binds this to dpg; tests drive it directly. `seed`
    seeds the student trainer's generators."""

    def __init__(self, teacher_trainer, field_mod, fcfg, dataset,
                 workspace: str = "workspace", cam: Optional[OrbitCamera] = None,
                 paint_res: int = 64, seed: int = 1):
        self.trainer = teacher_trainer
        self.field_mod = field_mod
        self.fcfg = fcfg
        self.dataset = dataset
        self.workspace = workspace
        self.cam = cam or OrbitCamera(800, 800)
        self.session = EditSession()
        self.budget = DynamicBudget()
        self.paint_res = paint_res
        self.painter = MaskPainter(paint_res, paint_res)
        self.seed = seed
        self.student = None
        self.show_student = False
        self.pretrain_only = False          # reference gui.py:511-515
        self.time_limit: Optional[float] = None  # wall-clock cap, :516-521
        self._train_started = None
        self._finetuning = False            # stage 2 set up
        self.time_value = 0.0               # D-NeRF slider (dnerf/gui.py)
        # reset anchor: the teacher as it was when the controller attached
        # (reference checkpoint reset, SealNeRF/gui.py:558-576)
        self._teacher_snapshot = _clone_tree(
            (teacher_trainer.state.params, teacher_trainer.state.ema_params))

    # ------------------------------------------------------------- rendering
    @property
    def render_trainer(self):
        return self.student if (self.show_student and self.student) else self.trainer

    def _render_pose(self, pose, h, w):
        tr = self.render_trainer
        if hasattr(tr, "render_image_t"):  # D-NeRF viewer: time slider
            return tr.render_image_t(pose, h, w, float(self.time_value))
        return tr.render_image(pose, h, w)

    def render_frame(self, full_h: int, full_w: int):
        t0 = time.time()
        ds = self.budget.downscale
        h, w = full_h // ds, full_w // ds
        with camera_intrinsics(self.render_trainer, self.cam.intrinsics / ds):
            img, depth = self._render_pose(self.cam.pose, h, w)
        img, depth = img.cpu().numpy(), depth.cpu().numpy()
        self.budget.update_preview((time.time() - t0) * 1000)
        return img, depth

    # ------------------------------------------------------- mask -> surface
    def lift_mask(self) -> np.ndarray:
        """Render depth at paint resolution and lift every painted pixel
        (batch — not the single-pixel pick of round 1)."""
        from seal3d_tpu_torch.data.rays import get_full_rays

        r = self.paint_res
        intr = self.cam.intrinsics * (r / self.cam.h)
        tr = self.trainer
        with camera_intrinsics(tr, intr):
            _, depth = tr.render_image(self.cam.pose, r, r)
        rays = get_full_rays(
            torch.as_tensor(self.cam.pose, device=tr.device),
            torch.as_tensor(intr, device=tr.device), r, r)
        return lift_pixels(rays["rays_o"].cpu().numpy(),
                           rays["rays_d"].cpu().numpy(), depth.cpu().numpy(),
                           self.painter.indices())

    def finish_stroke(self):
        """Drag released: lift the painted mask into the edit session."""
        self.painter.release()
        if not self.painter.any():
            return 0
        pts = self.lift_mask()
        if len(pts):
            self.session.paint(pts)
        self.painter.clear()
        return len(pts)

    def texture_config(self, image_path: str) -> dict:
        """Rect -> plane texture config: the session's last three painted
        'corner' points (o, w, h) define the image plane."""
        assert self.session.brush_points, "paint the rect corners first"
        pts = np.concatenate(self.session.brush_points)
        assert len(pts) >= 3, "need >= 3 lifted corner points"
        cfg = self.session.brush_config(normal=None)
        cfg["imageConfig"] = texture_rect_config(pts[:3], image_path)
        return cfg

    # ----------------------------------------------------------- edit cycle
    def start_edit(self, config: dict, pretrain_epochs: int = 1,
                   pretrain_batch: int = 2**15, **pretrain_kw):
        """Build mapper + student trainer and enter TRAIN (reference 'start'
        button, SealNeRF/gui.py:453-505). The student starts from the
        teacher's params and occupancy, on its device, with its options and
        a copy of its train config. Extra kwargs override PretrainConfig
        fields (e.g. coarser point steps for a faster interactive
        preview)."""
        from seal3d_tpu_torch.seal.mappers import build_mapper
        from seal3d_tpu_torch.seal.trainer import PretrainConfig, SealTrainer

        tr = self.trainer
        mapper = build_mapper(config, workspace=self.workspace)
        # a copy: stage 2 sets retune_warm on the student's config
        self.student = SealTrainer(
            self.field_mod, self.fcfg, tr.opts, dataclasses.replace(tr.cfg),
            mapper, teacher_params=tr.state.params,
            teacher_bitfield=tr.state.occ.bitfield, dataset=self.dataset,
            seed=self.seed, device=tr.device, name="gui_student")
        self.student.init_state()
        params = _clone_tree(tr.state.params)
        self.student.state = self.student.state._replace(
            params=params, ema_params=_clone_tree(params),
            occ=_clone_tree(tr.state.occ))
        self.student.init_pretraining(
            PretrainConfig(epochs=pretrain_epochs, batch_size=pretrain_batch,
                           **pretrain_kw))
        self._finetuning = False
        self.session.state = ToolState.TRAIN
        self.show_student = True
        self._train_started = time.time()

    def train_slice(self) -> bool:
        """One interactive training slice: a pretraining epoch while the
        student pretrains (`epochs` of them), else `budget.train_steps`
        finetune steps, the first of which sets stage 2 up (proxied
        dataset, fresh optimizer, hacked occupancy; not timed). Returns
        False when capped (time limit hit, or pretrain-only finished
        pretraining)."""
        if self.session.state is not ToolState.TRAIN or self.student is None:
            return False
        if (self.time_limit is not None
                and time.time() - self._train_started > self.time_limit):
            return False
        st = self.student
        if not (st.is_pretraining or self.pretrain_only or self._finetuning):
            st.proxy_datasets()
            st.start_finetune()
            self._finetuning = True
        t0 = time.time()
        if st.is_pretraining:
            st.pretrain_losses.append(st.pretrain_one_epoch())
            if len(st.pretrain_losses) >= st.pcfg.epochs:
                st.is_pretraining = False
        elif self.pretrain_only:
            return False
        else:
            n = self.budget.train_steps
            st.train(steps=n, log_every=n + 1)  # logs its first and last step
        self.budget.update_train((time.time() - t0) * 1000)
        return True

    # ------------------------------------------------------- ckpt management
    def save_checkpoint(self) -> str:
        """Save the active model (reference save button, gui.py:532-539)."""
        return self.render_trainer.save_checkpoint()

    def override_teacher(self):
        """Commit the edit: copy student weights (+EMA) into the teacher and
        clear the edit session (reference callback_override, gui.py:540-556)."""
        if self.student is None:
            return
        self.trainer.state = self.trainer.state._replace(
            params=_clone_tree(self.student.state.params),
            ema_params=_clone_tree(self.student.state.ema_params))
        self.student = None
        self.show_student = False
        self.session.reset()
        self.painter.clear()

    def reset_teacher(self):
        """Back to the pre-edit teacher (reference reset button,
        gui.py:558-576); the snapshot stays for the next reset."""
        params, ema = _clone_tree(self._teacher_snapshot)
        self.trainer.state = self.trainer.state._replace(
            params=params, ema_params=ema)
        self.student = None
        self.show_student = False
        self.session.reset()
        self.painter.clear()


class DynamicBudget:
    """The reference's interactivity scheduler (SURVEY.md §5.9): preview
    resolution adapts to hit <=200 ms/frame (SealNeRF/gui.py:348-353), train
    slice size adapts to <=500 ms (gui.py:212-217)."""

    def __init__(self, preview_ms: float = 200.0, train_ms: float = 500.0):
        self.preview_ms = preview_ms
        self.train_ms = train_ms
        self.downscale = 2
        self.train_steps = 16

    def update_preview(self, elapsed_ms: float):
        if elapsed_ms > self.preview_ms and self.downscale < 4:
            self.downscale += 1
        elif elapsed_ms < self.preview_ms * 0.5 and self.downscale > 1:
            self.downscale -= 1

    def update_train(self, elapsed_ms: float):
        per_step = elapsed_ms / max(self.train_steps, 1)
        self.train_steps = int(np.clip(self.train_ms / max(per_step, 1e-3),
                                       4, 64))
