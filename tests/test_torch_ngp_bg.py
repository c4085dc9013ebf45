"""The NGP background net (bg_radius > 0) in the port against the JAX
package, on the `xla` backend (the background grid always runs the plain
gather: a 2-D hash grid, L=4, F=2, T=2^19).

- init: the same keys and shapes as the reference's params;
- `background` on the same params, sphere coordinates and directions:
  within 1e-5 (the MLPs round to bf16 alike in both packages; only the fp32
  summation order differs), and the gradients of its leaves within 1e-4 of
  each leaf's largest entry;
- a whole `render_rays` with the background painted, on the packed flat and
  the [N, K] grid branches, from the same params (tables scaled up so the
  encodes drive the field) and the analytic scene's occupancy: image,
  depth and weights_sum within 1e-5;
- a `.pth` holding `encoder_bg` and `bg_net` through both packages' export
  and import, leaf for leaf bit-identical;
- the CLI with `--bg_radius`: the field carries the net, renders skip no
  chunk (a background chunk is painted, not left white).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_full_rays as j_full_rays
from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops.raymarch import sph_from_ray as j_sph
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as j_render_rays
from seal3d_tpu.train import checkpoint as jckpt
from seal3d_tpu_torch import main_nerf
from seal3d_tpu_torch.data.rays import get_full_rays as t_full_rays
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.ops.raymarch import sph_from_ray as t_sph
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.render.renderer import render_rays as t_render_rays
from seal3d_tpu_torch.train import checkpoint as tckpt
from seal3d_tpu_torch.train.checkpoint import flatten_tree, params_from_jax
from test_torch_train_step import OPTS, scene  # noqa: F401

BG_RADIUS = 4.0
KW = dict(bound=1.0, log2_hashmap_size=12, num_levels=4, grid_backend="xla",
          bg_radius=BG_RADIUS)
TOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """(JAX cfg, port cfg, JAX params, port params): the reference's init
    with every table scaled up to std ~0.5."""
    jcfg, tcfg = jngp.NGPConfig(**KW), tngp.NGPConfig(**KW)
    jp = jngp.init(jax.random.PRNGKey(4), jcfg)
    jp = dict(jp, **{k: jp[k] * 5e3 for k in ("encoder", "encoder_color",
                                              "encoder_bg")})
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_init_matches_jax_keys_and_shapes(params):
    jcfg, tcfg, jp, _ = params
    assert tcfg.grid_bg.level_params == tuple(
        tuple(p) for p in jcfg.grid_bg.level_params)
    want = {jckpt._path_str(p): a.shape
            for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    own = tngp.init(tcfg, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in flatten_tree(own)} == want
    assert "encoder_bg" in want and "bg_net/1/w" in want
    # no net without bg_radius
    plain = tngp.init(tngp.NGPConfig(**dict(KW, bg_radius=-1.0)),
                      generator=torch.Generator().manual_seed(0))
    assert "encoder_bg" not in plain and "bg_net" not in plain


def test_background_matches_jax(params):
    jcfg, tcfg, jp, tp = params
    o, d = _rays(4096)
    sph = np.asarray(j_sph(jnp.asarray(o), jnp.asarray(d), BG_RADIUS))
    np.testing.assert_allclose(
        t_sph(torch.from_numpy(o), torch.from_numpy(d), BG_RADIUS).numpy(),
        sph, atol=1e-6)
    want = np.asarray(jngp.background(jp, jcfg, jnp.asarray(sph),
                                      jnp.asarray(d)))
    got = tngp.background(tp, tcfg, torch.from_numpy(sph),
                          torch.from_numpy(d))
    assert np.abs(got.numpy() - want).max() <= TOL
    assert want.std() > 1e-3          # not a constant

    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    leaves = ("encoder_bg", "bg_net")
    jg = jax.grad(lambda q: (jngp.background(dict(jp, **q), jcfg,
                                             jnp.asarray(sph), jnp.asarray(d))
                             * cot).sum())({k: jp[k] for k in leaves})
    sub = {k: jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                           .requires_grad_(True), jp[k]) for k in leaves}
    flat = dict(flatten_tree(sub))
    out = tngp.background(dict(tp, **sub), tcfg, torch.from_numpy(sph),
                          torch.from_numpy(d))
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                list(flat.values()))
    want_g = {jckpt._path_str(p): np.asarray(a)
              for p, a in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for (k, _), g in zip(flat.items(), grads):
        ref = want_g[k]
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (k, err)


@pytest.mark.parametrize("flat_frac", [0.5, None])
def test_render_rays_with_background_matches_jax(params, scene,  # noqa: F811
                                                 flat_frac):
    jcfg, tcfg, jp, tp = params
    ds, occ = scene
    kw = dict(OPTS, bg_radius=BG_RADIUS, flat_frac=flat_frac)
    pose = ds.poses[1]
    jr = j_full_rays(jnp.asarray(pose), jnp.asarray(ds.intrinsics), ds.h, ds.w)
    want = j_render_rays(jp, jngp, jcfg, occ.bitfield, jr["rays_o"],
                         jr["rays_d"], JOpts(**kw), bg_color=1.0)
    tr = t_full_rays(torch.from_numpy(pose), torch.from_numpy(ds.intrinsics),
                     ds.h, ds.w)
    got = t_render_rays(tp, tngp, tcfg, torch.from_numpy(
        np.array(occ.bitfield)), tr["rays_o"], tr["rays_d"], TOpts(**kw),
        bg_color=1.0)
    for k in ("image", "depth", "weights_sum"):
        err = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert err <= TOL, (k, err)
    # the background shows: rays that leave the scene are not white
    empty = np.asarray(want["weights_sum"]) < 1e-3
    assert empty.any()
    assert np.abs(got["image"].numpy()[empty] - 1.0).max() > 0.3


def test_pth_with_encoder_bg_both_ways(params, tmp_path):
    jcfg, tcfg, jp, tp = params
    want = {jckpt._path_str(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    fresh_j = jngp.init(jax.random.PRNGKey(9), jcfg)
    fresh_t = tngp.init(tcfg, generator=torch.Generator().manual_seed(9))

    path = str(tmp_path / "port.pth")
    tckpt.export_torch_ngp(path, tp, step=3, grid_cfg=tcfg.grid)
    sd = torch.load(path, weights_only=True)["model"]
    assert "encoder_bg.embeddings" in sd and "bg_net.1.weight" in sd
    got = jckpt.import_torch_ngp(path, fresh_j, grid_cfg=jcfg.grid)
    for p, a in jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_array_equal(np.asarray(a), want[jckpt._path_str(p)])

    path = str(tmp_path / "jax.pth")
    jckpt.export_torch_ngp(path, jp, step=3, grid_cfg=jcfg.grid)
    got = tckpt.import_torch_ngp(path, fresh_t, grid_cfg=tcfg.grid)
    for k, v in flatten_tree(got):
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_cli_with_bg_radius(tmp_path, monkeypatch):
    monkeypatch.setattr(main_nerf, "NGPConfig",
                        functools.partial(tngp.NGPConfig, num_levels=4))
    ws = str(tmp_path / "ws")
    tr = main_nerf.main(["synthetic", "-O", "--bound", "1.0", "--dt_gamma",
                         "0", "--min_near", "0.05", "--max_steps", "512",
                         "--iters", "16", "--H", "24", "--W", "24",
                         "--num_rays", "256", "--log2_hashmap_size", "12",
                         "--bg_radius", "32", "--device", "cpu",
                         "--workspace", ws])
    assert tr.fcfg.bg_radius == 32 and tr.opts.bg_radius == 32
    assert "encoder_bg" in tr.state.params and "bg_net" in tr.state.params
    assert all(s["chunks_skipped"] == 0 for s in tr.render_stats)
    assert np.isfinite(tr.eval_history[-1]["psnr"])
    with np.load(os.path.join(ws, "checkpoints", "ngp_step0000016.npz")) as f:
        assert "params/encoder_bg" in f.files
        assert "opt_state/0/mu/bg_net/0/w" in f.files


def test_training_with_background_matches_jax(monkeypatch):
    """Both packages train the scene with the background net side by side:
    test_torch_train_parity.py's harness (the same rays, jitter and grid
    cells in both), its bucket backend, 64 steps. Val PSNR within 0.3 dB,
    block losses within 10%. On this white-background scene both fall short
    of the plain field (it fills with fog before the net learns white);
    chip_smoke phase 22(d) gates the net's cost on the card against the
    JAX package's at 576 steps (scripts/bg_gap_witness.py); `-s` prints
    both packages' PSNR with and without the net."""
    import test_torch_train_parity as tp

    monkeypatch.setattr(tp, "STEPS", 64)
    scene = (tp.JScene().make_dataset(n_views=8, h=24, w=24, seed=0),
             tp.JScene().make_dataset(n_views=2, h=24, w=24, seed=1))
    plain = tp._train_both(scene, "bucket", monkeypatch)
    monkeypatch.setattr(tp, "OPTS", dict(tp.OPTS, bg_radius=32.0))
    for mod in (jngp, tngp):
        monkeypatch.setattr(mod, "NGPConfig",
                            functools.partial(mod.NGPConfig, bg_radius=32.0))
    jl, tl, jpsnr, tpsnr = tp._train_both(scene, "bucket", monkeypatch)
    print(f"\n[bg parity] val PSNR with the background net: reference "
          f"{jpsnr:.3f} dB, port {tpsnr:.3f} dB; without: reference "
          f"{plain[2]:.3f} dB, port {plain[3]:.3f} dB")
    np.testing.assert_allclose(tl.reshape(-1, tp.BLOCK).mean(1),
                               jl.reshape(-1, tp.BLOCK).mean(1),
                               rtol=tp.BLOCK_LOSS_RTOL)
    assert abs(tpsnr - jpsnr) <= tp.PSNR_TOL_DB, (jpsnr, tpsnr)


def test_halo_pth_native_layout_drops_coarse_rows(tmp_path):
    """A `-O` (halo, wrap) field through `.pth`: exported in the reference's
    native layout (`grid_cfg` given), as both packages export it, the coarse
    levels lose the rows that wrap indexing reads past the native level
    size, and `apply` changes; exported in its own layout (no `grid_cfg`),
    it comes back bit for bit, and the JAX package's importer reads that
    file too. The background net's leaves survive both."""
    kw = dict(bound=1.0, log2_hashmap_size=15, grid_backend="halo",
              gridtype="wrap", bg_radius=BG_RADIUS)
    tcfg, jcfg = tngp.NGPConfig(**kw), jngp.NGPConfig(**kw)
    params = tngp.init(tcfg, generator=torch.Generator().manual_seed(0))
    fresh = tngp.init(tcfg, generator=torch.Generator().manual_seed(1))
    o, d = _rays(2048)
    x = torch.from_numpy(o) * 0.4
    d = torch.from_numpy(d)
    with torch.no_grad():
        want = tngp.apply(params, tcfg, x, d)
    for grid_cfg, exact in ((tcfg.grid, False), (None, True)):
        path = str(tmp_path / f"halo_{exact}.pth")
        tckpt.export_torch_ngp(path, params, grid_cfg=grid_cfg)
        got = tckpt.import_torch_ngp(path, fresh, grid_cfg=tcfg.grid)
        lost = int((got["encoder"] != params["encoder"]).any(-1).sum())
        with torch.no_grad():
            out = tngp.apply(got, tcfg, x, d)
        assert (lost == 0) == exact and all(
            torch.equal(a, b) for a, b in zip(out, want)) == exact, lost
        for k in ("encoder_bg", "bg_net"):
            for (_, a), (_, b) in zip(flatten_tree(got[k]),
                                      flatten_tree(params[k])):
                assert torch.equal(a, b), k
    jp = jckpt.import_torch_ngp(path, jngp.init(jax.random.PRNGKey(0), jcfg),
                                grid_cfg=jcfg.grid)
    np.testing.assert_array_equal(np.asarray(jp["encoder"]),
                                  params["encoder"].numpy())
