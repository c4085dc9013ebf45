"""The roofline and FLOP arithmetic, checked by hand on one shape, and the
reference's field against the port's plain field."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.reference import ngp as ref
from benchmark.reference import roofline

NGP = {"bound": 1.0, "num_levels": 16, "level_dim": 2, "base_resolution": 16,
       "desired_resolution": 2048, "log2_hashmap_size": 19,
       "num_layers": 2, "hidden_dim": 64, "geo_feat_dim": 15,
       "num_layers_color": 3, "hidden_dim_color": 64, "sh_degree": 4}


def test_encode_bound_by_hand():
    # a pretraining batch's forward: 2^19 rows, 16 levels, F=4 (the two
    # grids stacked); the table is not counted
    rows, levels, f = 2**19, 16, 4
    n_bytes, n_ops = roofline.encode_bytes_ops(rows, levels, f)
    assert n_bytes == rows * 12 + 4 * 4 * rows * 16
    assert n_bytes == 6_291_456 + 134_217_728 == 140_509_184
    assert n_ops == rows * 16 * (16 * 4 + 30) == 788_529_152
    least = roofline.encode_least_seconds(rows, levels, f)
    assert least == pytest.approx(140_509_184 / 3.35e12)   # bytes bound it
    assert least > 788_529_152 / 67e12


def test_field_flops_by_hand():
    per = roofline.ngp_field_flops(NGP)
    # sigma 32->64->16, colour 63->64->64->3; forward 2 a multiply-add,
    # backward twice the forward
    fwd = 2 * (32 * 64 + 64 * 16) + 2 * (63 * 64 + 64 * 64 + 64 * 3)
    assert fwd == 22_784
    assert per["mlp"] == 3 * fwd == 68_352
    assert per["fp32"] == 2 * 16 * (16 * 4 + 30) + 60 == 3_068
    pre = roofline.ngp_pretrain_flops(NGP)
    assert pre["mlp"] == 2 * fwd and pre["fp32"] == per["fp32"]
    t = roofline.least_seconds_mixed(989e12, 67e12)
    assert t == pytest.approx(2.0)


def test_roofline_reader_by_hand():
    """A K3 forward and a K2 backward launch, each against 1 ms of its own
    device time in a 10 ms window."""
    calls = [(2**19, 16, 4)]
    kernels = [("void hash_encode_fwd_kernel<4>(...)", 0.001, 0.002),
               ("void hash_encode_bwd_kernel<4>(...)", 0.003, 0.004),
               ("void other_kernel()", 0.005, 0.009)]
    tr = harness.Trace(window=(0.0, 0.010), kernels=kernels, ranges=[],
                       launches=3,
                       values={"encode_fwd": calls, "encode_bwd": calls,
                               "model_flops": {"mlp": 989e12 * 1e-3,
                                               "fp32": 0.0}})
    least = 140_509_184 / 3.35e12
    for name in ("k3_roofline.preview", "k2_roofline.preview"):
        mod = harness.load_module(
            f"{harness.HERE}/metrics/{name}.py", name.replace(".", "_"))
        assert mod.read(tr) == pytest.approx(100 * least / 0.001)
    assert harness.busy_seconds(tr) == pytest.approx(0.006)
    assert harness.device_idle(tr) == pytest.approx(40.0)
    assert harness.step_mfu(tr) == pytest.approx(10.0)
    assert harness.kernel_roofline(harness.Trace(
        window=(0, 1), kernels=[], ranges=[], launches=0),
        ("hash_encode_fwd",), []) is None


def test_reference_layout_is_the_port_bucket_layout():
    """The reference's native level layout at the published widths is the
    port's 'bucket' layout: the same offsets, sizes and hashed levels."""
    from seal3d_tpu_torch.models.ngp import NGPConfig

    grid = NGPConfig(bound=1.0, log2_hashmap_size=19, grid_backend="bucket",
                     gridtype="hash").grid
    ref_lp = [(r, o, n, h) for r, _, o, n, h in ref.level_layout(NGP)]
    assert ref_lp == [(r, o, n, h) for r, o, n, h, _ in grid.level_params]
    assert ref.table_rows(NGP) == grid.total_params
    assert sum(h for *_, h in ref_lp) >= 8     # the fine levels are hashed


def test_reference_field_matches_the_port_plain_field():
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.models.ngp import NGPConfig

    # level 0 dense, levels 1-3 hashed
    model = dict(NGP, num_levels=4, log2_hashmap_size=14)
    params = ref.make_params(model, 7, "cpu", table_scale=1.0)
    assert [h for *_, h in ref.level_layout(model)] == [False, True, True,
                                                        True]
    cfg = NGPConfig(bound=1.0, num_levels=4, log2_hashmap_size=14,
                    grid_backend="bucket", gridtype="hash")
    g = torch.Generator().manual_seed(0)
    x = torch.rand((4096, 3), generator=g) * 2 - 1
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g),
                                      dim=-1)
    s_p, c_p = ngp.apply(params, cfg, x, d)
    s_r, c_r = ref.field(params, model, x, d)
    assert torch.allclose(s_p, s_r, rtol=1e-5, atol=0)
    assert torch.allclose(c_p, c_r, rtol=0, atol=1e-6)
    s_c, _ = ref.field(params, model, x, d, prec=ref.CONTROL)
    assert (s_c - s_r).abs().max() / s_r.abs().max() > 1e-3
    assert math.isfinite(float(s_c.sum()))
