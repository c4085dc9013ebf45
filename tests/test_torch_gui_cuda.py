"""The GUI layer on the card: a headless NeRFViewer preview through K1 and
K4, and a SealController edit cycle, on a small -O field (16 levels F=2
stacked to F=4 at T=2^12 'wrap', the analytic scene's occupancy, tables
scaled up so the encode drives the field).

Imports torch and the port only (no JAX), so it also runs on a GPU machine
without JAX: python -m pytest --noconftest -m cuda tests/test_torch_gui_cuda.py

Without a CUDA device the tests skip. A preview at downscale 1 equals
`Trainer.render_image` at the camera's pose and intrinsics bit for bit (the
same kernels on the same inputs; K1's forward has no atomics), with K1
launched once a rendered chunk, and with K4 once a chunk's demand probe and
once a rendered chunk; the trainer's intrinsics stay the dataset's. The
edit cycle's snapshot, override and reset hold every leaf bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.config import common_parser
from seal3d_tpu_torch.data.synthetic import SyntheticScene
from seal3d_tpu_torch.gui.state import OrbitCamera, SealController, ToolState
from seal3d_tpu_torch.gui.viewer import NeRFViewer
from seal3d_tpu_torch.models import ngp
from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_bwd
from seal3d_tpu_torch.ops.ladder import ladder_plan
from seal3d_tpu_torch.render.occupancy import occupancy_init, occupancy_update
from seal3d_tpu_torch.render.renderer import RenderOptions
from seal3d_tpu_torch.train.checkpoint import flatten_tree
from seal3d_tpu_torch.train.trainer import TrainConfig, Trainer

OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05)
TCFG = dict(eval_chunk=2048, eval_budget_per_ray=48, eval_flat_frac=0.5,
            num_rays=1024)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _teacher(dev, workspace=None):
    scene = SyntheticScene()
    ds = scene.make_dataset(n_views=4, h=32, w=32, seed=0, device=dev)
    cfg = ngp.NGPConfig(bound=1.0, log2_hashmap_size=12, grid_backend="halo",
                        gridtype="wrap")
    tr = Trainer(ngp, cfg, RenderOptions(**OPTS),
                 TrainConfig(**TCFG, workspace=workspace), dataset=ds,
                 device=dev, name="gui_teacher")
    tr.init_state()
    p = dict(tr.state.params)
    p["encoder"], p["encoder_color"] = (p["encoder"] * 5e3,
                                        p["encoder_color"] * 5e3)
    occ = occupancy_update(occupancy_init(1, device=dev), scene.density, 1.0,
                           density_thresh=0.01, full=True,
                           generator=torch.Generator(dev).manual_seed(2))
    # a trained teacher's grid count: its slices update the grid partially
    occ = occ._replace(iter_density=torch.tensor(64, dtype=torch.int32,
                                                 device=dev))
    tr.state = tr.state._replace(params=p, ema_params=dict(p), occ=occ)
    return tr, ds


def _leaves(tree) -> dict:
    return {k: v.clone() for k, v in flatten_tree(tree)}


def _equal(tree, want: dict) -> bool:
    got = dict(flatten_tree(tree))
    return set(got) == set(want) and all(torch.equal(got[k], v)
                                         for k, v in want.items())


@pytest.mark.cuda
@pytest.mark.parametrize("tl_kernel", [False, True])
def test_preview_equals_render_image_on_card(cuda_device, tl_kernel):
    tr, ds = _teacher(cuda_device)
    tr.eval_opts = dataclasses.replace(tr.eval_opts, tl_kernel=tl_kernel)
    args = common_parser("t").parse_args(
        ["synthetic", "--H", "96", "--W", "96", "--radius", "2.5", "--test"])
    v = NeRFViewer(args, tr)
    v.cam.orbit(40.0, -20.0)
    v.budget.downscale = 1
    for fn in (halo_encode, halo_encode_bwd, ladder_plan):
        fn.launches = 0
    frame = v.render_frame().copy()
    torch.cuda.synchronize()
    st = tr.render_stats[-1]
    n_chunks = -(-96 * 96 // TCFG["eval_chunk"])
    assert st["nonfinite"] == 0 and st["chunks_rendered"] > 0
    assert halo_encode.launches == st["chunks_rendered"]
    assert halo_encode_bwd.launches == 0
    assert ladder_plan.launches == (n_chunks + st["chunks_rendered"]
                                    if tl_kernel else 0)
    assert torch.equal(tr._intrinsics.cpu(),
                       torch.as_tensor(ds.intrinsics, dtype=torch.float32))
    saved = tr._intrinsics
    tr._intrinsics = torch.as_tensor(v.cam.intrinsics, device=cuda_device)
    ref, _ = tr.render_image(v.cam.pose, 96, 96)
    tr._intrinsics = saved
    np.testing.assert_array_equal(frame, ref.cpu().numpy())
    assert float(frame.std()) > 0.02       # the object is in view


@pytest.mark.cuda
def test_controller_cycle_bit_exact_on_card(cuda_device, tmp_path):
    tr, ds = _teacher(cuda_device, workspace=str(tmp_path))
    p0, e0 = _leaves(tr.state.params), _leaves(tr.state.ema_params)
    ctl = SealController(tr, ngp, tr.fcfg, ds, workspace=str(tmp_path),
                         cam=OrbitCamera(64, 64, radius=2.2), paint_res=32)
    ctl.session.state = ToolState.BRUSH
    ctl.painter.drag(12, 16)
    ctl.painter.drag(20, 16)
    assert ctl.finish_stroke() > 0
    ctl.start_edit(ctl.session.brush_config(), pretrain_epochs=1,
                   pretrain_batch=2**15, local_point_step=0.02,
                   surrounding_point_step=0.06, global_point_step=0.15)
    st = ctl.student
    assert st.device == tr.device and _equal(st.state.params, p0)
    assert ctl.train_slice() and not st.is_pretraining
    ctl.budget.train_steps = 4
    assert ctl.train_slice() and int(st.state.step) == 4
    img, _ = ctl.render_frame(64, 64)
    assert np.isfinite(img).all()
    sp, se = _leaves(st.state.params), _leaves(st.state.ema_params)
    ctl.override_teacher()
    assert _equal(tr.state.params, sp) and _equal(tr.state.ema_params, se)
    st.state.params["encoder"].add_(1.0)      # the override wrote clones
    assert _equal(tr.state.params, sp)
    ctl.reset_teacher()
    assert _equal(tr.state.params, p0) and _equal(tr.state.ema_params, e0)
