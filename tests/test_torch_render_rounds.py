"""Transmittance-terminated rounds (RenderOptions.term_rounds > 1) in the
port against the JAX package.

- `composite_flat` with `tau_in` on a packed buffer with invalid tail
  slots: weights, per-ray sums and `tau_out` against the reference's exact
  scatter mode within 1e-5 (the port's scan mode too: its prefixes are
  float64; the reference's own scan is held to its stated ~2e-3).
- `render_rays` with term_rounds 2 and 4, on the single-level and the
  two-level march, at the default round budgets: the same
  analytic field (the synthetic scene's density and colour as a field
  module) and the same analytic occupancy, one 24x24 view. Image, depth and
  weights_sum against the reference (run eagerly, as
  test_torch_train_step.py explains) within 1e-5 (fp32; the two scenes'
  densities agree to float rounding), and the port's rounds, at the
  default and at equal round budgets, against its own single round at the
  thresholds of tests/test_render_paths.py:437-471.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.data.rays import get_full_rays as j_full_rays
from seal3d_tpu.data.synthetic import SyntheticScene as JScene
from seal3d_tpu.ops.composite import composite_flat as j_composite_flat
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as j_render_rays
from seal3d_tpu.render.renderer import round_budget_fracs as j_fracs
from seal3d_tpu_torch.data.rays import get_full_rays as t_full_rays
from seal3d_tpu_torch.data.synthetic import SyntheticScene as TScene
from seal3d_tpu_torch.ops.composite import composite_flat as t_composite_flat
from seal3d_tpu_torch.ops.raymarch import compact_flat_direct
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.render.renderer import render_rays as t_render_rays
from seal3d_tpu_torch.render.renderer import round_budget_fracs as t_fracs
from test_torch_train_step import OPTS, scene  # noqa: F401

TOL = 1e-5
BASE = dict(OPTS, budget_per_ray=64, flat_frac=0.75)
TWO_LEVEL = dict(march_two_level=True, tl_group=4, tl_pool=64, tl_kg=-1,
                 tl_over=2.5)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _JField:
    """The reference's analytic scene as a field module."""

    @staticmethod
    def apply(params, cfg, x, d):
        return cfg.density(x), cfg.color(x, d)


class _TField:
    """The port's analytic scene as a field module."""

    @staticmethod
    def apply(params, cfg, x, d, valid=None):
        return cfg.density(x), cfg.color(x, d)


def _close(got, want, tol=TOL):
    for k in ("image", "depth", "weights_sum"):
        err = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert err <= tol, (k, err)


@pytest.mark.parametrize("seg_mode", ["scatter", "scan"])
def test_composite_flat_tau_in_matches_jax(seg_mode):
    rng = np.random.default_rng(11)
    n, c = 32, 24
    ts = np.sort(rng.uniform(0.1, 3.0, (n, c)), axis=1).astype(np.float32)
    dts = rng.uniform(0.01, 0.05, (n, c)).astype(np.float32)
    valid = rng.uniform(size=(n, c)) > 0.3
    rays_o = rng.normal(size=(n, 3)).astype(np.float32)
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    budget = int(valid.sum()) + 40     # invalid tail pads past the samples
    mf = compact_flat_direct(*(torch.from_numpy(a) for a in
                               (ts, dts, valid, rays_o, rays_d)), c, budget)
    sig = (2.0 + torch.sin(mf.xyzs.sum(-1))) * mf.valid
    rgb = torch.sigmoid(mf.xyzs)
    tau_in = rng.uniform(0, 2, (n,)).astype(np.float32)
    args = (sig, rgb, mf.deltas, mf.ts, mf.ray_id, mf.offsets, mf.valid, n)
    jargs = [jnp.asarray(a.numpy()) for a in args[:-1]] + [n]
    for ti in (None, tau_in):
        got = t_composite_flat(*args, tau_in=None if ti is None else
                               torch.from_numpy(ti), seg_mode=seg_mode)
        exact = j_composite_flat(*jargs, tau_in=None if ti is None else
                                 jnp.asarray(ti), seg_mode="scatter")
        same = j_composite_flat(*jargs, tau_in=None if ti is None else
                                jnp.asarray(ti), seg_mode=seg_mode)
        assert set(got) == set(exact)
        for key in exact:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(exact[key]), atol=TOL,
                                       rtol=TOL, err_msg=key)
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(same[key]), atol=3e-3,
                                       rtol=1e-3, err_msg=key)
    out = t_composite_flat(*args, tau_in=torch.from_numpy(tau_in),
                           seg_mode=seg_mode)
    # rounds chain: a first round of zero depth leaves tau_in unchanged
    assert (out["tau_out"] >= torch.from_numpy(tau_in)).all()


def test_round_budget_fracs_match_jax():
    for r in (1, 2, 3, 4, 8):
        np.testing.assert_allclose(t_fracs(r), j_fracs(r), rtol=1e-12)
        assert abs(sum(t_fracs(r)) - 0.8) < 1e-12


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("rounds", [2, 4])
def test_term_rounds_match_jax(scene, rounds, two_level):  # noqa: F811
    ds, occ = scene
    pose = ds.poses[1]
    extra = dict(TWO_LEVEL if two_level else {}, term_rounds=rounds)
    jopts, topts = JOpts(**BASE, **extra), TOpts(**BASE, **extra)
    assert topts.two_level_ok(BASE["budget_per_ray"]) == two_level
    jr = j_full_rays(jnp.asarray(pose), jnp.asarray(ds.intrinsics), ds.h,
                     ds.w)
    with jax.disable_jit():
        want = j_render_rays(None, _JField, JScene(), occ.bitfield,
                             jr["rays_o"], jr["rays_d"], jopts)
    tr = t_full_rays(torch.from_numpy(pose), torch.from_numpy(ds.intrinsics),
                     ds.h, ds.w)
    bitfield = torch.from_numpy(np.array(occ.bitfield))
    got = t_render_rays(None, _TField, TScene(), bitfield, tr["rays_o"],
                        tr["rays_d"], topts)
    _close(got, want)
    assert int(got["num_samples"]) > 0

    # against the port's own single round on the same march, with the
    # default round budgets and with equal ones
    single = t_render_rays(None, _TField, TScene(), bitfield, tr["rays_o"],
                           tr["rays_d"],
                           dataclasses.replace(topts, term_rounds=1))
    equal = dataclasses.replace(topts,
                                term_budget_fracs=(1.0 / rounds,) * rounds)
    for opts in (topts, equal):
        multi = t_render_rays(None, _TField, TScene(), bitfield,
                              tr["rays_o"], tr["rays_d"], opts)
        err = (multi["image"] - single["image"]).abs().numpy()
        assert err.mean() < 1e-3, err.mean()
        assert (err > 2e-2).mean() < 2e-3, (err > 2e-2).mean()
        werr = (multi["weights_sum"] - single["weights_sum"]).abs().numpy()
        assert werr.mean() < 1e-3, werr.mean()


def test_ineligible_rounds_fall_back_to_one_round(scene):  # noqa: F811
    """A ladder that does not divide into the rounds renders as one round,
    as in the reference."""
    ds, occ = scene
    tr = t_full_rays(torch.from_numpy(ds.poses[0]),
                     torch.from_numpy(ds.intrinsics), ds.h, ds.w)
    bitfield = torch.from_numpy(np.array(occ.bitfield))
    opts = TOpts(**BASE)
    one = t_render_rays(None, _TField, TScene(), bitfield, tr["rays_o"],
                        tr["rays_d"], opts)
    odd = t_render_rays(None, _TField, TScene(), bitfield, tr["rays_o"],
                        tr["rays_d"], dataclasses.replace(opts, term_rounds=3))
    for k in ("image", "depth", "weights_sum"):
        assert torch.equal(one[k], odd[k]), k
