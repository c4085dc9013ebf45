"""Port parity of the march options against the JAX package: the
span-adaptive ladder (`span_adaptive`), `flat_select='gather'` (the
reference's rank-inversion pack `compact_flat_gather` against the port's
sort pack, which gives the same packing), the group-granular march
(`march_rays_flat_grouped`, `group_compact`), the legacy scatter compaction
(`compact_samples`, `march_rays`, `compaction='flat'`), the last helpers
(`compact_grid_to_flat`, `pooled_dilated32`) and the two-level march with
jitter (the train march of `march_two_level=True`).

The march cases use tests/test_torch_train_march.py's scene (N=256 rays,
C=256 candidates, max_steps 512, coarse 64, occ_stride 4, k=48, jitter).
The JAX functions run eagerly, op by op, as that file explains. Integer
outputs (valid masks, ray ids, offsets, counts) must be exact; floats within
1e-6 on valid slots.

`render_rays` under each option runs a small NGP field (4 levels at T=2^12
on the fp32 `xla` encode) with the JAX params carried over by
`params_from_jax`: image, depth and weights_sum within 1e-4 (the field's own
tolerance against the JAX field, tests/test_torch_ngp.py: the bf16 MLPs sum
in another order); the parameter gradients of the group-granular render
within 1e-2 of each leaf's largest entry (tests/test_torch_train_step.py's
step tolerance). `group_compact` where its gate fails (dt_gamma > 0, or
span_adaptive) renders what the single-level march renders, as in JAX.
The Trainer's eval demand and the SealTrainer's teacher demand count the
span-adaptive ladder, exactly as the formula over eager JAX does.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from seal3d_tpu.models import ngp as jngp
from seal3d_tpu.ops import raymarch as jrm
from seal3d_tpu.render.renderer import RenderOptions as JOpts
from seal3d_tpu.render.renderer import render_rays as j_render_rays
from seal3d_tpu_torch.models import ngp as tngp
from seal3d_tpu_torch.ops import raymarch as trm
from seal3d_tpu_torch.render.renderer import RenderOptions as TOpts
from seal3d_tpu_torch.render.renderer import render_rays as t_render_rays
from seal3d_tpu_torch.train.checkpoint import (flatten_tree, map_tree,
                                               params_from_jax)
from test_torch_train_march import K, TRAIN, _assert_same_pack, _j, _t
from test_torch_train_march import inputs  # noqa: F401

RENDER_TOL = 1e-4
GRAD_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _march_kw(inputs, jittered):  # noqa: F811
    ro, rd, bf, jitter, aabb = inputs
    jit = jitter if jittered else None
    j = dict(rays_o=_j(ro), rays_d=_j(rd), bitfield=_j(bf), aabb=_j(aabb),
             perturb=None if jit is None else _j(jit))
    t = dict(rays_o=_t(ro), rays_d=_t(rd), bitfield=_t(bf), aabb=_t(aabb),
             perturb=None if jit is None else _t(jit))
    return j, t


def _assert_same_grid(j, t):
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    for name in ("xyzs", "dirs", "deltas", "ts"):
        np.testing.assert_allclose(getattr(t, name).numpy()[jv],
                                   np.asarray(getattr(j, name))[jv],
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------- the span-adaptive ladder

@pytest.mark.parametrize("jittered", [False, True])
def test_candidate_ts_span_adaptive(inputs, jittered):  # noqa: F811
    """Per-ray steps clipped at both ends: short spans take dt_min, long
    ones dt_max, and misses (near = far = 1e9) dt_min."""
    jitter = inputs[3]
    rng = np.random.default_rng(5)
    nears = rng.uniform(0.05, 1.5, 256).astype(np.float32)
    fars = (nears + rng.uniform(0.0, 3.0, 256)).astype(np.float32)
    nears[:4], fars[:4] = 1e9, 1e9
    kw = dict(num_steps=64, dt_gamma=0.0, bound=1.0, max_steps=512,
              span_adaptive=True)
    pj = _j(jitter) if jittered else None
    pt = _t(jitter) if jittered else None
    jts, jdts, jv = jrm.candidate_ts(_j(nears), _j(fars), perturb=pj, **kw)
    tts, tdts, tv = trm.candidate_ts(_t(nears), _t(fars), perturb=pt, **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tts.numpy(), np.asarray(jts), rtol=1e-6)
    np.testing.assert_array_equal(tdts.numpy(), np.asarray(jdts))
    dt = tdts[:, 0].numpy()
    dt_min, dt_max = 2 * 3**0.5 / 512, 2 * 3**0.5 / 128
    assert (np.isclose(dt, dt_min).sum() > 4 and np.isclose(dt, dt_max).sum()
            > 4 and ((dt > dt_min * 1.01) & (dt < dt_max * 0.99)).sum() > 50)


@pytest.mark.parametrize("jittered", [False, True])
def test_march_candidates_and_grid_span_adaptive(inputs,  # noqa: F811
                                                 jittered):
    jk, tk = _march_kw(inputs, jittered)
    j = jrm.march_candidates(**jk, span_adaptive=True, **TRAIN)
    t = trm.march_candidates(**tk, span_adaptive=True, **TRAIN)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-6)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=1e-6)
    assert int(t[2].sum()) > 0
    jg = jrm.march_rays_grid(**jk, k=K, span_adaptive=True, **TRAIN)
    tg = trm.march_rays_grid(**tk, k=K, span_adaptive=True, **TRAIN)
    _assert_same_grid(jg, tg)
    # the ladder spans the tightened interval: steps above dt_min exist
    assert float(tg.deltas[tg.valid].max()) > 2 * 3**0.5 / 512 * 1.01


# ---------------------------------------------------------- the gather pack

def _real_candidates(inputs):  # noqa: F811
    ro, rd, bf, jitter, aabb = inputs
    ts, dts, valid = trm.march_candidates(_t(ro), _t(rd), _t(bf),
                                          perturb=_t(jitter), aabb=_t(aabb),
                                          **TRAIN)
    return ts.numpy(), dts.numpy(), valid.numpy(), ro, rd


def _random_candidates():
    """tests/test_render_paths.py's mixed case: dense rays (over k), sparse
    and empty ones, at n=64, C=96, k=16."""
    rng = np.random.default_rng(7)
    n, c = 64, 96
    ts = np.sort(rng.uniform(0.1, 2.0, (n, c)).astype(np.float32), axis=1)
    dts = np.full((n, c), 0.01, np.float32)
    valid = rng.random((n, c)) < rng.uniform(0.0, 0.9, (n, 1))
    ro = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ts, dts, valid, ro, rd


def _gather_cases(inputs):  # noqa: F811
    """(name, candidates, k, budget): the real march at budgets in
    overflow, mid and roomy; the random case at test_render_paths.py's
    three; one ray keeping all 256 candidates (in the reference's uint8
    ranks its rank 0 - 1 wraps to 255, which is never asked for)."""
    real = _real_candidates(inputs)
    demand = int(trm.ray_stride_keep(torch.from_numpy(real[2]), K)[0].sum())
    rnd = _random_candidates()
    full = tuple(a.copy() for a in real)
    full[2][3] = True          # ray 3: every candidate valid and kept
    cases = [("real", real, K, b) for b in
             (demand // 3, demand - 7, 256 * K)]
    cases += [("random", rnd, 16, b) for b in (128, 384, 1024)]
    cases += [("all256", full, 256, 256 * 256)]
    return cases, demand


def test_compact_flat_gather_matches_jax_and_direct(inputs):  # noqa: F811
    """The reference's rank-inversion pack against the port's sort pack,
    which serves flat_select='gather' in the port: the same packing."""
    cases, demand = _gather_cases(inputs)
    assert 1000 < demand < 256 * K
    for name, cand, k, budget in cases:
        jargs = [_j(a) for a in cand]
        targs = [torch.from_numpy(a) for a in cand]
        j = jrm.compact_flat_gather(*jargs, k, budget)
        t = trm.compact_flat_direct(*targs, k, budget)
        _assert_same_pack(j, t)
        # and the reference's own two packs agree on the valid slots
        d = jrm.compact_flat_direct(*jargs, k, budget)
        v = np.asarray(d.valid)
        np.testing.assert_array_equal(np.asarray(j.valid), v, err_msg=name)
        for f in ("ray_id", "ts", "deltas", "xyzs", "dirs"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f))[v],
                                          np.asarray(getattr(d, f))[v],
                                          err_msg=f"{name} {budget} {f}")
        if name == "all256":
            assert int(t.counts[3]) == 256
            np.testing.assert_array_equal(
                t.ts[t.ray_id == 3][:256].numpy(), cand[0][3])


@pytest.mark.parametrize("budget", [2048, 256 * K])   # over, under budget
def test_compact_flat_sharded_gather_matches_jax(inputs, budget):  # noqa: F811
    cand = _real_candidates(inputs)
    j = jrm.compact_flat_sharded(jrm.compact_flat_gather,
                                 *[_j(a) for a in cand], K, budget, 2)
    t = trm.compact_flat_sharded(*[torch.from_numpy(a) for a in cand], K,
                                 budget, 2)
    _assert_same_pack(j, t)
    assert int(t.valid.sum()) > 0


@pytest.mark.parametrize("budget", [1024, 256 * K // 2])
def test_march_rays_flat_select_gather(inputs, budget):  # noqa: F811
    """The whole train march with select='gather' and jitter (the
    reference's gather pack, the port's sort pack), and with the
    span-adaptive ladder under it."""
    jk, tk = _march_kw(inputs, True)
    for span in (False, True):
        kw = dict(TRAIN, k=K, budget=budget, span_adaptive=span,
                  select="gather")
        _assert_same_pack(jrm.march_rays_flat(**jk, **kw),
                          trm.march_rays_flat(**tk, **kw))


# ------------------------------------------------- the group-granular march

@pytest.mark.parametrize("k,budget", [(K, 256 * K), (16, 1024)])
def test_march_rays_flat_grouped_matches_jax(inputs, k, budget):  # noqa: F811
    """Under budget at k=48, and at k=16 (kg=4: most hit rays keep every
    stride-th group) in a budget that ends mid-batch."""
    jk, tk = _march_kw(inputs, True)
    kw = {key: v for key, v in TRAIN.items() if key != "dt_gamma"}
    kw.update(k=k, budget=budget)
    j = jrm.march_rays_flat_grouped(**jk, **kw)
    t = trm.march_rays_flat_grouped(**tk, **kw)
    _assert_same_pack(j, t)
    dt_min = 2 * 3**0.5 / 512
    assert int(t.valid.sum()) > 0 and int(t.counts.sum()) % 4 == 0
    if k == 16:
        assert float(t.deltas[t.valid].max()) > 2 * dt_min
        assert int(t.counts.sum()) == budget


# -------------------------------------------- the legacy flat compaction

@pytest.mark.parametrize("budget", [256 * 64, 3000])
def test_march_rays_legacy_matches_jax(inputs, budget):  # noqa: F811
    """compaction='flat': every candidate tested, no coarse tightening, no
    thinning. At 3000 slots the trailing rays lose their samples."""
    ro, rd, bf, jitter, aabb = inputs
    kw = dict(bound=1.0, cascades=1, dt_gamma=0.0, max_steps=512,
              num_candidates=256, min_near=0.05, budget=budget)
    j = jrm.march_rays(_j(ro), _j(rd), _j(bf), perturb=_j(jitter),
                       aabb=_j(aabb), **kw)
    t = trm.march_rays(_t(ro), _t(rd), _t(bf), perturb=_t(jitter),
                       aabb=_t(aabb), **kw)
    _assert_same_pack(j, t)
    np.testing.assert_array_equal(t.ray_id.numpy(), np.asarray(j.ray_id))
    for name in ("xyzs", "dirs", "deltas", "ts"):   # zeros off the samples
        np.testing.assert_array_equal(getattr(t, name).numpy()[~t.valid],
                                      0.0)
    counts = t.counts.numpy()
    if budget == 3000:
        assert t.valid.all() and counts.sum() == budget
        assert (counts[-50:] == 0).all() and counts[:100].sum() > 0
    else:
        assert int(t.valid.sum()) == counts.sum() < budget


def test_compact_samples_matches_jax():
    """The scatter compaction alone on random candidates, at a budget that
    cuts a ray's segment in two."""
    ts, dts, valid, ro, rd = _random_candidates()
    budget = int(valid.sum()) // 2
    j = jrm.compact_samples(*[_j(a) for a in (ts, dts, valid, ro, rd)],
                            budget)
    t = trm.compact_samples(*[torch.from_numpy(a)
                              for a in (ts, dts, valid, ro, rd)], budget)
    _assert_same_pack(j, t)
    assert t.valid.all() and 0 < int(t.counts[t.counts > 0][-1]) < \
        int(valid.sum(1)[t.counts.numpy() > 0][-1])


# ------------------------------------------------------- the last helpers

@pytest.mark.parametrize("budget", [700, 256 * K])
def test_compact_grid_to_flat_matches_jax(inputs, budget):  # noqa: F811
    jk, tk = _march_kw(inputs, True)
    jg = jrm.march_rays_grid(**jk, k=K, **TRAIN)
    tg = trm.march_rays_grid(**tk, k=K, **TRAIN)
    _assert_same_pack(jrm.compact_grid_to_flat(jg, budget),
                      trm.compact_grid_to_flat(tg, budget))


def test_pooled_dilated32_matches_jax(inputs):  # noqa: F811
    bf = inputs[2]
    j = np.asarray(jrm.pooled_dilated32(_j(bf), 1))
    t = trm.pooled_dilated32(_t(bf), 1).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0 < t.sum() < t.size
    bf2 = np.concatenate([bf, bf[::-1]])           # two cascades
    np.testing.assert_array_equal(trm.pooled_dilated32(_t(bf2), 2).numpy(),
                                  np.asarray(jrm.pooled_dilated32(_j(bf2), 2)))


def test_two_level_train_march_matches_jax(inputs):  # noqa: F811
    """march_two_level=True on a train step: the default tl_kg=0 cap and
    the jittered start through group_plan and the two packs."""
    jk, tk = _march_kw(inputs, True)
    kw = {key: v for key, v in TRAIN.items() if key != "dt_gamma"}
    kw.update(k=K, budget=256 * K // 2, group=8, kg=0, pool=32)
    _assert_same_pack(jrm.march_rays_flat_2level(**jk, **kw),
                      trm.march_rays_flat_2level(**tk, **kw))


# ------------------------------------------------------------ render_rays

NGP = dict(bound=1.0, log2_hashmap_size=12, num_levels=4,
           grid_backend="xla", gridtype="hash")
BASE = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05,
            flat_frac=0.5)
OPTIONS = {
    "gather": dict(flat_select="gather"),
    "span_adaptive": dict(span_adaptive=True),
    "group_compact": dict(group_compact=True),
    "legacy_flat": dict(compaction="flat"),
    "two_level_train": dict(march_two_level=True),
    "span_adaptive_grid": dict(span_adaptive=True, flat_frac=None),
}


@pytest.fixture(scope="module")
def field():
    jcfg = jngp.NGPConfig(**NGP)
    p = jngp.init(jax.random.PRNGKey(3), jcfg)
    # tables scaled up so the encode drives the field
    p = dict(p, encoder=p["encoder"] * 5e3,
             encoder_color=p["encoder_color"] * 5e3)
    return jcfg, p, tngp.NGPConfig(**NGP), params_from_jax(
        jax.tree.map(np.asarray, p))


def _renders(inputs, field, opts_kw, grads=False):  # noqa: F811
    ro, rd, bf, _, aabb = inputs
    jcfg, jp, tcfg, tp = field
    key = jax.random.PRNGKey(9)
    jitter = np.array(jax.random.uniform(key, (ro.shape[0],)))
    jopts, topts = JOpts(**opts_kw), TOpts(**opts_kw)

    def jrender(p):
        return j_render_rays(p, jngp, jcfg, _j(bf), _j(ro), _j(rd), jopts,
                             key=key, perturb=True, aabb=_j(aabb))

    def trender(p):
        return t_render_rays(p, tngp, tcfg, _t(bf), _t(ro), _t(rd), topts,
                             aabb=_t(aabb), jitter=_t(jitter))

    if not grads:
        with torch.no_grad():
            return jrender(jp), trender(tp)
    jg = jax.grad(lambda p: jrender(p)["image"].mean())(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_tree(tp)}
    trender(map_tree(tp, lambda k, _: leaves[k]))["image"].mean().backward()
    return jg, {k: v.grad for k, v in leaves.items()}


def _assert_close_render(j, t, tol=RENDER_TOL):
    for k in ("image", "depth", "weights_sum"):
        err = np.abs(t[k].numpy() - np.asarray(j[k])).max()
        assert err <= tol, (k, err)
    assert int(t["num_samples"]) == int(j["num_samples"]) > 0


@pytest.mark.parametrize("option", list(OPTIONS))
def test_render_rays_option_matches_jax(inputs, field, option):  # noqa: F811
    j, t = _renders(inputs, field, dict(BASE, **OPTIONS[option]))
    _assert_close_render(j, t)
    assert float(t["weights_sum"].max()) > 0.5


def test_group_compact_gradients_match_jax(inputs, field):  # noqa: F811
    jg, tg = _renders(inputs, field, dict(BASE, group_compact=True),
                      grads=True)
    jflat = dict(zip([k for k, _ in flatten_tree(field[3])],
                     jax.tree.leaves(jg)))
    for k, g in tg.items():
        ref = np.asarray(jflat[k])
        scale = float(np.abs(ref).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy() / scale, ref / scale,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("fallback", [dict(dt_gamma=1 / 128),
                                      dict(span_adaptive=True)])
def test_group_compact_falls_back_to_single_level(inputs, field,  # noqa: F811
                                                  fallback):
    """Where the grouped march's gate fails, group_compact renders the
    single-level march's result in both packages, and raises in neither."""
    opts = dict(BASE, **fallback)
    j, t = _renders(inputs, field, dict(opts, group_compact=True))
    _assert_close_render(j, t)
    _, single = _renders(inputs, field, opts)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_array_equal(t[k].numpy(), single[k].numpy())
    grouped = dataclasses.replace(TOpts(**BASE), group_compact=True)
    from seal3d_tpu_torch.render.renderer import _grouped_ok, flat_budget
    assert _grouped_ok(grouped, flat_budget(256, grouped))
    assert not _grouped_ok(TOpts(**opts, group_compact=True),
                           flat_budget(256, grouped))


# ---------------------------------------------------- the demand probes

def _kept_demand(valid, k):
    """The packing's per-ray stride cap over a [N, C] validity mask."""
    valid = np.asarray(valid)
    rank = np.cumsum(valid, axis=1)
    stride = np.maximum(np.ceil(rank[:, -1:] / k).astype(np.int64), 1)
    return int((valid & ((rank - 1) % stride == 0)).sum())


def test_demand_probes_take_span_adaptive(inputs, field):  # noqa: F811
    """The eval demand (span_adaptive turns the two-level eval march off:
    the single-level formula) and the Seal teacher demand count the
    span-adaptive ladder's candidates, equal to the formula over eager
    JAX's march_candidates, and not the uniform ladder's."""
    import types

    from seal3d_tpu_torch.seal.trainer import SealTrainer
    from seal3d_tpu_torch.train.trainer import TrainConfig as TCfg
    from seal3d_tpu_torch.train.trainer import Trainer as TTrainer

    ro, rd, bf, _, aabb = inputs
    ek = 48
    tr = TTrainer(tngp, field[2], TOpts(**BASE, span_adaptive=True),
                  TCfg(eval_budget_per_ray=ek, eval_flat_frac=0.375),
                  device="cpu")
    eo = tr.eval_opts
    assert eo.span_adaptive and not tr._eval_tl_uncapped
    n_valid = 200
    kw = dict(bound=1.0, cascades=1, dt_gamma=0.0, max_steps=512,
              num_candidates=256, min_near=0.05, occ_stride=4)

    def want(span, **extra):
        valid = np.array(jrm.march_candidates(
            _j(ro), _j(rd), _j(bf), span_adaptive=span, **kw, **extra)[2])
        valid[n_valid:] = False
        return _kept_demand(valid, ek)

    got = tr._eval_demand(_t(bf), _t(ro), _t(rd), _t(aabb), n_valid)
    ev = dict(aabb=_j(aabb), coarse_steps=eo.coarse_steps)
    assert got.tolist() == [want(True, **ev), 0]
    assert want(True, **ev) != want(False, **ev)
    # without coarse tightening the spans outgrow 256 dt_min
    teacher = types.SimpleNamespace(_teacher_opts=TOpts(
        **dict(BASE, budget_per_ray=ek, coarse_steps=0), span_adaptive=True))
    n_valid = ro.shape[0]
    got = SealTrainer._teacher_demand(teacher, _t(bf), _t(ro), _t(rd))
    assert int(got) == want(True) != want(False)
