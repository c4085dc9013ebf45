"""Port parity of the TensoRF field (VM and CP) against the JAX package:
the frequency encoding, the factor lookups with their VJPs, `apply`,
`density`, `color` and `background` with the gradient of every leaf,
`density_loss`, and the resolution surgeries (`upsample_model`,
`shrink_model`, `n_to_reso`, the voxel schedule). Every input is drawn from
a seed with numpy and handed to both packages.

Tolerances: fp32 on both sides, only the summation order differs. Values
within 1e-6 (lookups, the encoding) or 1e-5 (the field, the resizes);
gradients within 1e-6 (lookups) or 1e-5 (the field) of each leaf's largest
entry. The colour MLP rounds its inputs to bf16 in both packages, so a
feature one fp32 ulp apart could round to neighbouring bf16 values; the
field's inputs here are far from such ties (checked: outputs agree to
1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.models import tensorf as jtf
from seal3d_tpu.ops import freq as jfreq
from seal3d_tpu.ops.raymarch import sph_from_ray as j_sph
from seal3d_tpu.train.checkpoint import _path_str
from seal3d_tpu.train.tensorf_trainer import TensoRFTrainer as JTrainer
from seal3d_tpu_torch.models import tensorf as ttf
from seal3d_tpu_torch.ops import freq as tfreq
from seal3d_tpu_torch.ops.raymarch import sph_from_ray as t_sph
from seal3d_tpu_torch.train.checkpoint import (flatten_tree, map_tree,
                                               params_from_jax)
from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer as TTrainer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMALL = dict(resolution=(20, 17, 23), sigma_rank=(3, 2, 4),
             color_rank=(4, 3, 5), hidden_dim=16, bg_resolution=(12, 9),
             bg_rank=3, hidden_dim_bg=16)


def _cfgs(decomposition, bg=False):
    kw = dict(SMALL, decomposition=decomposition,
              bg_radius=4.0 if bg else -1.0)
    if decomposition == "cp":  # one rank for the three lines
        kw.update(sigma_rank=(3, 3, 3), color_rank=(5, 5, 5))
    return jtf.TensoRFConfig(**kw), ttf.TensoRFConfig(**kw)


def _params(jcfg, seed=0):
    jp = jtf.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _points(n, seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


def _close_rel(got, want, rtol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


def _jpaths(tree):
    return {_path_str(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_freq_encode_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 5)).astype(np.float32) * 3
    for degree in (0, 2, 4):
        want = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree))
        got = tfreq.freq_encode(torch.from_numpy(x), degree).numpy()
        assert got.shape == want.shape == (37, tfreq.freq_encode_dim(5, degree))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _coords(n, seed):
    """Coordinates in and outside [-1, 1], with exact -1, 1 and 0 among
    them (where the clip's gradient is split)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.3, 1.3, size=n).astype(np.float32)
    c[:6] = [-1.0, 1.0, 0.0, -1.0, 1.0, 1.2]
    return c


@pytest.mark.parametrize("align_corners", [True, False])
def test_sample_plane_and_line_match_jax_with_vjps(align_corners):
    rng = np.random.default_rng(1)
    plane = rng.normal(size=(3, 9, 14)).astype(np.float32)
    line = rng.normal(size=(4, 11)).astype(np.float32)
    cx, cy = _coords(200, 2), _coords(200, 3)
    cy[3:5] = [1.0, -1.0]  # corners of the plane
    ct_p = rng.normal(size=(3, 200)).astype(np.float32)
    ct_l = rng.normal(size=(4, 200)).astype(np.float32)

    def jplane(p, x, y):
        return jtf.sample_plane(p, x, y, align_corners=align_corners)

    def jline(v, c):
        return jtf.sample_line(v, c, align_corners=align_corners)

    jo, jvjp = jax.vjp(jplane, jnp.asarray(plane), jnp.asarray(cx),
                       jnp.asarray(cy))
    jg = jvjp(jnp.asarray(ct_p))
    tp, tx, ty = (torch.from_numpy(a).requires_grad_(True)
                  for a in (plane, cx, cy))
    to = ttf.sample_plane(tp, tx, ty, align_corners=align_corners)
    tg = torch.autograd.grad(to, (tp, tx, ty), torch.from_numpy(ct_p))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=1e-6)
    # outside the box the sample is exactly zero
    out = (np.abs(cx) > 1) | (np.abs(cy) > 1)
    assert out.any() and (to.detach().numpy()[:, out] == 0).all()
    for g, want, what in zip(tg, jg, ("plane", "cx", "cy")):
        _close_rel(g.numpy(), want, 1e-6, f"sample_plane VJP {what}")

    jo, jvjp = jax.vjp(jline, jnp.asarray(line), jnp.asarray(cx))
    jg = jvjp(jnp.asarray(ct_l))
    tl, tc = (torch.from_numpy(a).requires_grad_(True) for a in (line, cx))
    to = ttf.sample_line(tl, tc, align_corners=align_corners)
    tg = torch.autograd.grad(to, (tl, tc), torch.from_numpy(ct_l))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=1e-6)
    for g, want, what in zip(tg, jg, ("line", "c")):
        _close_rel(g.numpy(), want, 1e-6, f"sample_line VJP {what}")


def _field_loss_j(jcfg, x, d, cs, cr, sph=None, cb=None):
    def loss(p):
        sigma, rgb = jtf.apply(p, jcfg, x, d)
        total = (sigma * cs).sum() + (rgb * cr).sum()
        if sph is not None:
            total = total + (jtf.background(p, jcfg, sph, d) * cb).sum()
        return total
    return loss


@pytest.mark.parametrize("decomposition,bg", [("vm", False), ("cp", False),
                                              ("vm", True)])
def test_field_matches_jax_with_leaf_gradients(decomposition, bg):
    jcfg, tcfg = _cfgs(decomposition, bg)
    jp, tp = _params(jcfg, seed=3)
    # params_from_jax carries the tree (lists of factors, the background)
    # leaf for leaf
    carried = dict(flatten_tree(tp))
    assert carried.keys() == _jpaths(jp).keys()
    for k, v in _jpaths(jp).items():
        np.testing.assert_array_equal(carried[k].numpy(), v, err_msg=k)
    own = ttf.init(tcfg, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in flatten_tree(own)} == \
        {k: tuple(v.shape) for k, v in flatten_tree(tp)}
    x, d = _points(96, 4, -0.95, 0.95)
    rng = np.random.default_rng(5)
    cs = rng.normal(size=96).astype(np.float32) * 1e-2
    cr = rng.normal(size=(96, 3)).astype(np.float32)
    cb = rng.normal(size=(96, 3)).astype(np.float32)
    xj, dj = jnp.asarray(x), jnp.asarray(d)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)

    js, jc = jtf.apply(jp, jcfg, xj, dj)
    ts, tc = ttf.apply(tp, tcfg, xt, dt, valid=torch.ones(96, dtype=bool))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    jd = jtf.density(jp, jcfg, xj)
    td = ttf.density(tp, tcfg, xt)
    assert td["geo_feat"] is None and jd["geo_feat"] is None
    np.testing.assert_allclose(td["sigma"].numpy(), np.asarray(jd["sigma"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ttf.color(tp, tcfg, xt, dt).numpy(),
                               np.asarray(jtf.color(jp, jcfg, xj, dj)),
                               rtol=0, atol=1e-5)

    sph_j = sph_t = None
    if bg:
        o = np.random.default_rng(6).uniform(-0.5, 0.5, (96, 3)).astype(
            np.float32)
        sph_j = j_sph(jnp.asarray(o), dj, jcfg.bg_radius)
        sph_t = t_sph(torch.from_numpy(o), dt, tcfg.bg_radius)
        np.testing.assert_allclose(sph_t.numpy(), np.asarray(sph_j), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(
            ttf.background(tp, tcfg, sph_t, dt).numpy(),
            np.asarray(jtf.background(jp, jcfg, sph_j, dj)), rtol=0,
            atol=1e-5)

    jg = _jpaths(jax.grad(_field_loss_j(jcfg, xj, dj, jnp.asarray(cs),
                                        jnp.asarray(cr), sph_j,
                                        jnp.asarray(cb)))(jp))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_tree(tp)}
    tree = map_tree(tp, lambda k, _: leaves[k])
    sigma, rgb = ttf.apply(tree, tcfg, xt, dt)
    total = (sigma * torch.from_numpy(cs)).sum() + \
        (rgb * torch.from_numpy(cr)).sum()
    if bg:
        total = total + (ttf.background(tree, tcfg, sph_t, dt)
                         * torch.from_numpy(cb)).sum()
    tg = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    assert set(tg) == set(jg)
    for k in jg:
        _close_rel(tg[k].numpy(), jg[k], 1e-5, f"gradient of {k}")
    # aabb has a gradient (through the normalisation): the finetune quirk
    assert np.abs(jg["aabb"]).max() > 0


@pytest.mark.parametrize("decomposition", ["vm", "cp"])
def test_density_loss_matches_jax(decomposition):
    jcfg, tcfg = _cfgs(decomposition)
    jp, tp = _params(jcfg, seed=7)
    np.testing.assert_allclose(float(ttf.density_loss(tp, tcfg)),
                               float(jtf.density_loss(jp, jcfg)), rtol=1e-6)


@pytest.mark.parametrize("decomposition,res", [
    ("vm", (300, 40, 31)),   # every axis grows
    ("vm", (37, 9, 31)),     # y shrinks 17 -> 9, the others grow
    ("cp", (12, 33, 23)),
])
def test_upsample_model_matches_jax(decomposition, res):
    jcfg, tcfg = _cfgs(decomposition)
    jp, tp = _params(jcfg, seed=8)
    want = _jpaths(jtf.upsample_model(jp, jcfg, res))
    got = dict(flatten_tree(ttf.upsample_model(tp, tcfg, res)))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def _density_grid(seed):
    """[1, 128^3] grid: noise below 0.01 with an occupied box of cells
    (Morton order)."""
    from seal3d_tpu_torch.ops.morton import morton3d

    rng = np.random.default_rng(seed)
    grid = rng.uniform(0, 0.005, size=128**3).astype(np.float32)
    ax = [np.arange(a, b) for a, b in ((20, 90), (35, 101), (50, 77))]
    cells = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    codes = morton3d(torch.from_numpy(cells)).numpy()
    grid[codes] = rng.uniform(1.0, 5.0, size=len(codes))
    return grid[None]


@pytest.mark.parametrize("decomposition", ["vm", "cp"])
def test_shrink_model_matches_jax(decomposition):
    jcfg, tcfg = _cfgs(decomposition)
    jp, tp = _params(jcfg, seed=9)
    grid = _density_grid(10)
    mean = float(grid.clip(min=0).mean())
    want = _jpaths(jtf.shrink_model(jp, jcfg, grid, mean, 10.0))
    got = dict(flatten_tree(ttf.shrink_model(tp, tcfg, torch.from_numpy(grid),
                                             mean, 10.0)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert tuple(got["sigma_vec/0"].shape) != tuple(tp["sigma_vec"][0].shape)
    # no occupied cell: the params unchanged
    empty = np.zeros_like(grid)
    assert ttf.shrink_model(tp, tcfg, torch.from_numpy(empty), 0.0) is tp


def test_n_to_reso_and_voxel_schedule_match_jax():
    for aabb in ([-1, -1, -1, 1, 1, 1], [-0.61, -0.43, -0.72, 0.58, 0.49, 0.7]):
        a = np.asarray(aabb, np.float32)
        for n in (128**3, 300**3, 5000):
            assert ttf.n_to_reso(n, torch.from_numpy(a)) == \
                jtf.n_to_reso(n, jnp.asarray(a))
    for steps in ((), (300,), (300, 500, 700, 900, 1100),
                  (2000, 3000, 4000, 5500, 7000)):
        want = JTrainer._voxel_schedule(steps, 128**3, 300**3)
        got = TTrainer._voxel_schedule(steps, 128**3, 300**3)
        assert {k: int(v) for k, v in got.items()} == \
            {k: int(v) for k, v in want.items()}
