"""The port's TensoRF VM field and its Seal-3D pretraining step against the
benchmark's plain reference (`benchmark/reference/tensorf.py`: factors
sampled by `F.grid_sample`, nothing of the port), on seeded random weights
at 24^3 with the published ranks (16 / 48), basis (27) and colour MLP
(3 x 128), 4,096 rows; and the factor lookups' autograd Functions against
the formula they replace (four / two gathers and the blend, differentiated
by autograd), with their host counters.

Tolerances: the two sides compute the same fp32 bilinear arithmetic in
another order (`grid_sample`'s weights against the port's blend) and sum
the factors' cotangents in another order, so fp32 values differ by a few
ulps; the colour MLP's bf16 operands round the same values on both sides.
"""

import json
import os

import pytest
import torch

from benchmark.reference import tensorf as ref
from seal3d_tpu_torch.models import tensorf
from seal3d_tpu_torch.models.tensorf import TensoRFConfig
from seal3d_tpu_torch.ops.tensorf_vm import _clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "seal-tensorf-VM.json")
RES = 24
ROWS = 4096


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    with open(CONFIG) as f:
        m = json.load(f)["model"]
    return dict(m, resolution=[RES] * 3)


@pytest.fixture(scope="module")
def params(model):
    return ref.make_params(model, 2**31 + 7, "cpu", factor_scale=0.4)


def _cfg():
    return TensoRFConfig(bound=1.0, resolution=(RES,) * 3)


def _rows(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((ROWS, 3), generator=g) * 2 - 1
    d = torch.nn.functional.normalize(torch.randn((ROWS, 3), generator=g),
                                      dim=-1)
    return x, d


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_field_matches_the_reference(params, model):
    x, d = _rows()
    s_p, c_p = tensorf.apply(params, _cfg(), x, d)
    s_r, c_r = ref.field(params, model, x, d)
    # the same fp32 blend in another order: ~1e-7 relative
    assert float(((s_p - s_r).abs() / s_r).max()) < 1e-5
    # features a few ulps apart round to the neighbouring bf16 MLP operand
    # on a rare row, which moves its colour by ~1e-5
    assert float((c_p - c_r).abs().max()) < 1e-4
    assert float(((c_p - c_r).abs() > 1e-6).float().mean()) < 0.01
    # the precision below the stated one is far outside both
    s_c, c_c = ref.field(params, model, x, d, prec=ref.CONTROL)
    assert float(((s_c - s_r).abs() / s_r).max()) > 1e-4
    assert float((c_c - c_r).abs().max()) > 1e-3


def _grads(params, fn):
    leaves = {k: v.clone().requires_grad_(k != "aabb")
              for k, v in ref.flatten(params).items()}
    s, c = fn(ref.unflatten_like(params, leaves))
    loss = torch.log1p(s).sum() + (c * torch.linspace(-1, 1, 3)).sum()
    keys = [k for k in leaves if k != "aabb"]
    return dict(zip(keys, torch.autograd.grad(loss, [leaves[k]
                                                     for k in keys])))


def test_every_leaf_gradient_matches_the_reference(params, model):
    x, d = _rows(1)
    g_p = _grads(params, lambda p: tensorf.apply(p, _cfg(), x, d))
    g_r = _grads(params, lambda p: ref.field(p, model, x, d))
    assert len(g_p) == 16
    for k in g_r:
        # another summation order of the scatters (fp32): ~1e-7; the
        # colour MLP's weight cotangents are bf16 on both sides
        assert _rel(g_p[k], g_r[k]) < 1e-5, k


def test_three_pretraining_steps_match_the_reference(params, model):
    """Three SealTrainer steps of a bbox edit against the reference's
    RefPretrainer on its own shells and batches (the teacher's answers its
    own: a student equal to its teacher reads a zero L1 residual, whose
    sign elsewhere is rounding noise): losses, Adam's first moment after
    the first, every leaf after the third."""
    import dataclasses

    from benchmark.reference import seal as ref_seal
    from benchmark.traffic.seal_preview_tensorf import program_configs
    from seal3d_tpu_torch.seal.mappers import build_mapper
    from seal3d_tpu_torch.seal.trainer import PretrainConfig, SealTrainer

    with open(CONFIG) as f:
        config = json.load(f)
    config["model"] = model
    with open(os.path.join(ROOT, "benchmark/edits/bbox.json")) as f:
        edit = json.load(f)
    fcfg, opts, tcfg = program_configs(config)
    st = SealTrainer(tensorf, fcfg, opts, tcfg, build_mapper(edit),
                     teacher_params=params,
                     teacher_bitfield=torch.zeros(128**3 // 8,
                                                  dtype=torch.uint8),
                     device="cpu")
    pcfg = PretrainConfig(batch_size=ROWS, lr=config["pretrain"]["lr"],
                          local_point_step=0.04, surrounding_point_step=0.08,
                          global_point_step=0.25)
    st.train_edit(pcfg, finetune_steps=0, pretrain_epochs=0, proxy=False,
                  log=False)
    batches = [{k: v[k][b] for k in ("points", "dirs", "sigma", "color",
                                     "weight")}
               for v in st.pretrain_data.values()
               for b in range(v["n_batches"])]
    ref_batches = ref_seal.batches(ref.shells(
        ref_seal.build_mapper(edit, "cpu"), params, model,
        dataclasses.asdict(pcfg), "cpu"), ROWS)
    assert len(batches) == len(ref_batches) == 3
    rp = ref.RefPretrainer(model, pcfg.lr, params)
    for i, (batch, ref_batch) in enumerate(zip(batches, ref_batches)):
        assert torch.equal(batch["points"], ref_batch["points"])
        loss_p = float(st._pretrain_step(batch))
        loss_r, g_r = rp.step(ref_batch)
        # the same fp32 loss of fields a few ulps apart
        assert loss_p == pytest.approx(float(loss_r), rel=1e-5)
        if i == 0:
            mu = dict(ref.flatten(st._pre_opt_state[0].mu))
            assert set(mu) == set(rp.mu) == {k for k in rp.params
                                             if k != "aabb"}
            for k in mu:
                assert _rel(mu[k], rp.mu[k]) < 1e-5, k
    after = ref.flatten(st.state.params)
    ema = ref.flatten(st.state.ema_params)
    start = ref.flatten(params)
    assert torch.equal(after["aabb"], start["aabb"])
    for k in rp.params:
        if k == "aabb":
            continue
        # Adam divides by the root of the second moment: an element whose
        # three gradients nearly cancel can take the other sign's steps, a
        # few lr apart, so a leaf is held by its change's norm (as the
        # benchmark's change_gap: ~1e-5 and under) and by the share of its
        # elements that move alike
        for d_p, d_r in ((after[k] - start[k], rp.params[k] - start[k]),
                         (ema[k] - start[k], rp.ema[k] - start[k])):
            gap = abs(float(d_p.norm() / d_r.norm()) - 1.0)
            assert d_r.norm() > 0 and gap < 1e-4, k
            apart = (d_p - d_r).abs() > 0.01 * pcfg.lr
            assert float(apart.float().mean()) < 0.01, k


# ------------------------------------------------- the lookups' Functions

def _plane_formula(plane, cx, cy, align_corners):
    """The plane lookup before it became a Function: gathers and blend,
    differentiated by autograd."""
    r, h, w = plane.shape
    inside = (cx.abs() <= 1.0) & (cy.abs() <= 1.0)
    if align_corners:
        x = (_clip(cx, -1.0, 1.0) + 1.0) * 0.5 * (w - 1)
        y = (_clip(cy, -1.0, 1.0) + 1.0) * 0.5 * (h - 1)
    else:
        x = _clip((cx + 1.0) * 0.5 * w - 0.5, 0.0, w - 1.0)
        y = _clip((cy + 1.0) * 0.5 * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 2)
    fx, fy = x - x0, y - y0
    flat = plane.reshape(r, h * w)
    i00 = y0 * w + x0
    v00, v01 = flat.index_select(1, i00), flat.index_select(1, i00 + 1)
    v10, v11 = flat.index_select(1, i00 + w), flat.index_select(1, i00 + w + 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return out * inside[None, :]


def _line_formula(line, c, align_corners):
    r, d = line.shape
    inside = c.abs() <= 1.0
    if align_corners:
        x = (_clip(c, -1.0, 1.0) + 1.0) * 0.5 * (d - 1)
    else:
        x = _clip((c + 1.0) * 0.5 * d - 0.5, 0.0, d - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, d - 2)
    fx = x - x0
    return ((line.index_select(1, x0) * (1 - fx)
             + line.index_select(1, x0 + 1) * fx) * inside[None, :])


@pytest.mark.parametrize("align_corners", (True, False))
def test_lookup_functions_match_the_formula(align_corners):
    g = torch.Generator().manual_seed(3)
    plane, line = torch.randn(5, 7, 9, generator=g), torch.randn(5, 11,
                                                                 generator=g)
    cx = torch.rand(300, generator=g) * 2.4 - 1.2
    cy = torch.rand(300, generator=g) * 2.4 - 1.2
    # ties at +-1 on either axis, and rows outside on one axis only
    cx[:6] = torch.tensor([1.0, -1.0, 1.0, -1.0, 0.0, 1.2])
    cy[:6] = torch.tensor([0.3, -1.0, 1.0, 1.2, -1.0, 0.5])
    w_p = torch.randn(5, 300, generator=g)
    w_l = torch.randn(5, 300, generator=g)
    outs = []
    for plane_fn, line_fn in ((_plane_formula, _line_formula),
                              (tensorf.sample_plane, tensorf.sample_line)):
        p, ln = plane.clone().requires_grad_(), line.clone().requires_grad_()
        a, b = cx.clone().requires_grad_(), cy.clone().requires_grad_()
        o_p, o_l = plane_fn(p, a, b, align_corners), line_fn(ln, a,
                                                             align_corners)
        grads = torch.autograd.grad((o_p * w_p).sum() + (o_l * w_l).sum(),
                                    [p, ln, a, b])
        outs.append((o_p, o_l) + grads)
    (op0, ol0, gp0, gl0, ga0, gb0), (op1, ol1, gp1, gl1, ga1, gb1) = outs
    assert torch.equal(op1, op0) and torch.equal(ol1, ol0)
    # the scatters sum each cell's terms in another order than autograd's
    # dense sum of four index_add_ results
    assert torch.allclose(gp1, gp0, rtol=0, atol=1e-5)
    assert torch.allclose(gl1, gl0, rtol=0, atol=1e-5)
    # the coordinates' cotangent is the formula's up to the order of its
    # fp32 sums over the rank: zero outside, and at +-1 half
    # (align_corners, where +-1 is the clip's tie) or zero (where +-1 lies
    # half a cell past it), exactly where the formula's is
    for new, old in ((ga1, ga0), (gb1, gb0)):
        assert torch.allclose(new, old, rtol=1e-5, atol=1e-5)
        assert torch.equal(new == 0, old == 0)
    assert ga1[5] == 0 and gb1[3] == 0
    assert (ga1[:4].abs().min() > 0) == align_corners


def test_lookup_counters_count_rows_as_calls_are_issued():
    keys = ("lookup_rows", "lookup_points", "scatter_rows", "scatter_points")
    before = {k: dict(getattr(tensorf, k)) for k in keys}
    plane = torch.randn(16, 6, 6, requires_grad=True)
    line = torch.randn(48, 6, requires_grad=True)
    c = torch.rand(100) * 2 - 1
    out = tensorf.sample_plane(plane, c, c).sum() + tensorf.sample_line(
        line, c).sum()
    with torch.no_grad():           # a teacher's query: gathers only
        tensorf.sample_line(line, c)
    out.backward()
    delta = {k: {kind: getattr(tensorf, k)[kind] - before[k][kind]
                 for kind in ("plane", "line")} for k in keys}
    assert delta == {"lookup_rows": {"plane": 1600, "line": 9600},
                     "lookup_points": {"plane": 100, "line": 200},
                     "scatter_rows": {"plane": 1600, "line": 4800},
                     "scatter_points": {"plane": 100, "line": 100}}
