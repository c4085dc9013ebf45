"""Interactive GUI over the port's trainers (port of seal3d_tpu/gui/: the
reference's nerf/gui.py, dnerf/gui.py and SealNeRF/gui.py).

The logic lives in gui/state.py and runs headless; gui/viewer.py binds it to
dearpygui. `launch_gui` and `launch_seal_gui` (the CLIs' `--gui`) need
dearpygui and raise RuntimeError where it does not import: there is no
headless fallback."""

from seal3d_tpu_torch.gui.state import (DynamicBudget, EditSession,
                                        MaskPainter, OrbitCamera,
                                        SealController, ToolState,
                                        camera_intrinsics, depth_lift,
                                        lift_pixels, texture_rect_config)

try:
    import dearpygui.dearpygui  # noqa: F401

    HAS_DPG = True
except ImportError:
    HAS_DPG = False


def launch_gui(args, trainer):
    """Viewer + live training (reference NeRFGUI, nerf/gui.py:55); a time
    slider over a D-NeRF trainer."""
    if not HAS_DPG:
        raise RuntimeError(
            "dearpygui is not installed; run headless via the CLI instead "
            "(the reference GUI stack needs `pip install dearpygui`)")
    from seal3d_tpu_torch.gui.viewer import NeRFViewer

    NeRFViewer(args, trainer).render()


def launch_seal_gui(args, field_mod, fcfg, make_trainer):
    """Editing frontend (reference SealNeRF/gui.py:97)."""
    if not HAS_DPG:
        raise RuntimeError(
            "dearpygui is not installed; run headless edits via "
            "main_SealNeRF --seal_config <dir>")
    from seal3d_tpu_torch.gui.viewer import SealViewer

    SealViewer(args, field_mod, fcfg, make_trainer).render()

