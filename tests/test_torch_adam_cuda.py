"""Adam and the EMA as one launch on the card (csrc/adam_ema.cu through
ops/adam.py, reached by `Optimizer.update_with_ema`) against the plain chain
it replaces (train/optim.py `Optimizer.update`, `apply_updates`, then the
EMA e * d + p * (1 - d) over every leaf): three steps on the benchmark
cells' real leaf sets (NGP's two T=2^19 tables moved and five MLP leaves
EMA-only; TensoRF VM-192's sixteen leaves at 300^3 moved and `aabb`
EMA-only), on leaves of 1, 3 and 5 elements, a misaligned view, a
decaying schedule with net_scale; more leaves than one launch takes,
refused; the two output sets alternating, never over an input; then a
Seal-3D pretraining step on a small NGP and a small TensoRF student: no
host sync, the state passed in left as it was, the optimizer state's tree
unchanged.

Imports torch and the port only (no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_adam_cuda.py

Without a CUDA device the tests skip (the kernel has no CPU mode).

Tolerance: none. The kernel runs the chain's operations in its order with
one rounding each (no FMA contraction; the same powf, IEEE division and
square root), so every leaf, moment, EMA and count is equal bit for bit.
"""

import math

import pytest
import torch

from seal3d_tpu_torch.models import ngp, tensorf
from seal3d_tpu_torch.ops import adam as fused
from seal3d_tpu_torch.train.checkpoint import flatten_tree, map_tree, map_trees
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates

DECAY = 0.95
BBOX = {"type": "bbox",
        "raw": [[0.15, -0.1, -0.2], [0.55, -0.1, -0.2], [0.15, 0.3, -0.2],
                [0.15, -0.1, 0.2], [0.55, 0.3, -0.2], [0.55, -0.1, 0.2],
                [0.15, 0.3, 0.2], [0.55, 0.3, 0.2]],
        "transform": [[1, 0, 0, 0], [0, 1, 0, 0.35], [0, 0, 1, 0],
                      [0, 0, 0, 1]],
        "scale": [1, 1, 1]}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused Adam kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def plain_chain(opt, grads, state, params, ema):
    """The chain the kernel replaces, as `_pretrain_step` ran it."""
    updates, state = opt.update(grads, state)
    params = {**params, **apply_updates({k: params[k] for k in grads},
                                        updates)}
    return params, state, map_trees(
        lambda e, p: e * DECAY + p * (1.0 - DECAY), ema, params)


def _grads(tree, gen):
    """Gradients shaped like `tree`, half their entries zero (as a hash
    table's untouched rows), the others of several magnitudes."""
    def one(_, t):
        g = torch.randn(t.shape, generator=gen, device=t.device)
        g = g * torch.exp2(torch.randint(-20, 4, t.shape, generator=gen,
                                         device=t.device).float())
        return g * (torch.rand(t.shape, generator=gen, device=t.device) < 0.5)
    return map_tree(tree, one)


def _unequal(a, b) -> list:
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    return [k for (k, x), (_, y) in zip(fa, fb) if not torch.equal(x, y)]


def _run_both(opt, params, moved_keys, dev, steps=3, seed=0):
    """`steps` steps of the kernel and of the plain chain from the same
    state -> the keys where they differ, and the kernel's launches."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ema = map_tree(params, lambda _, t: t + 0.01 * torch.randn(
        t.shape, generator=gen, device=dev))
    state = opt.init({k: params[k] for k in moved_keys})
    a = b = (params, state, ema)
    n = fused.adam_ema.launches
    for _ in range(steps):
        grads = _grads({k: params[k] for k in moved_keys}, gen)
        a = opt.update_with_ema(grads, a[1], a[0], a[2], DECAY)
        b = plain_chain(opt, grads, b[1], b[0], b[2])
    return _unequal(a, b), fused.adam_ema.launches - n


def ngp_leaves(dev):
    """NGP at the benchmark's widths (`bucket`, T=2^19): the two tables
    move, the five MLP weights are EMA-only."""
    gen = torch.Generator(device=dev).manual_seed(1)
    params = ngp.init(ngp.NGPConfig(grid_backend="bucket"), generator=gen,
                      device=dev)
    return params, [k for k in params if "encoder" in k]


def tensorf_leaves(dev):
    """TensoRF VM-192 at 300^3: every leaf but `aabb` moves."""
    torch.manual_seed(2)    # its init draws on the host and on `dev`
    params = tensorf.init(tensorf.TensoRFConfig(resolution=(300, 300, 300)),
                          device=dev)
    return params, [k for k in params if k != "aabb"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ngp", "tensorf"])
def test_real_leaf_sets_match_the_plain_chain(cuda_device, cell):
    params, moved = (ngp_leaves if cell == "ngp" else tensorf_leaves)(
        cuda_device)
    n_leaves = len(flatten_tree(params))
    assert (n_leaves, len(flatten_tree({k: params[k] for k in moved}))) == (
        (7, 2) if cell == "ngp" else (17, 16))
    bad, launches = _run_both(Optimizer(0.07, math.inf), params, moved,
                              cuda_device)
    assert bad == [] and launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("opt", [Optimizer(0.07, math.inf),
                                 Optimizer(0.01, 2, net_scale=0.25),
                                 Optimizer(3e-3, None, b2=0.999, eps=1e-8)],
                         ids=["constant", "decay-net_scale", "adam"])
def test_small_and_misaligned_leaves(cuda_device, opt):
    """Leaves of 1, 3 and 5 elements, a contiguous view 4 bytes off the
    16-byte grid (the scalar path: its gradient is aligned), a leaf of
    2 chunks and 3 elements; an `encoder` entry and others, so net_scale
    scales some."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    base = torch.randn(2 * fused.CHUNK + 40, generator=gen,
                       device=cuda_device)
    view = base[1:1 + 2 * fused.CHUNK + 3]
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    params = {"encoder": [torch.randn(n, generator=gen, device=cuda_device)
                          for n in (1, 3, 5)] + [view],
              "net": {"w": torch.randn(7, 3, generator=gen,
                                       device=cuda_device)},
              "frozen": torch.randn(5, generator=gen, device=cuda_device)}
    bad, launches = _run_both(opt, params, ["encoder", "net"], cuda_device)
    assert bad == [] and launches == 3


@pytest.mark.cuda
def test_more_leaves_than_a_launch_takes_are_refused(cuda_device):
    params = [torch.ones(3, device=cuda_device)
              for _ in range(fused.MAX_LEAVES + 1)]
    with pytest.raises(ValueError, match="more than a launch"):
        fused.adam_ema(params, params, params, params, params,
                       count=torch.zeros((), dtype=torch.int32,
                                         device=cuda_device),
                       sched_count=None, lr=0.1, b1=0.9, b2=0.99, eps=1e-15,
                       decay=0.95)


@pytest.mark.cuda
def test_output_sets_alternate_and_spare_the_inputs(cuda_device):
    """The third step writes into the first one's tensors, with no
    allocation; a set that a call is given is never written, so a caller
    that passes one state again and again (the benchmark's `unchanged`
    fault) keeps it whole while the moments move on, as the plain chain's
    do."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    params = {"encoder": [torch.randn(n, generator=gen, device=cuda_device)
                          for n in (5000, 3)],
              "frozen": torch.randn(5, generator=gen, device=cuda_device)}
    ema = map_tree(params, lambda _, t: t + 0.5)
    opt = Optimizer(0.07, math.inf)
    moved = {"encoder": params["encoder"]}
    r0 = (params, opt.init(moved), ema)
    r1 = opt.update_with_ema(_grads(moved, gen), r0[1], r0[0], r0[2], DECAY)
    r2 = opt.update_with_ema(_grads(moved, gen), r1[1], r1[0], r1[2], DECAY)
    grads = _grads(moved, gen)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    r3 = opt.update_with_ema(grads, r2[1], r2[0], r2[2], DECAY)
    assert torch.cuda.memory_allocated() == held

    def addrs(r):
        return [t.data_ptr() for _, t in flatten_tree(r)]

    assert addrs((r3[0]["encoder"], r3[1][0], r3[2])) == addrs(
        (r1[0]["encoder"], r1[1][0], r1[2]))
    assert not set(addrs(r3)) & set(addrs((r2[0]["encoder"], r2[1][0])))

    # the `unchanged` fault: the parameters and EMA passed in every time
    keep = [t.clone() for _, t in flatten_tree((params, ema))]
    a = b = r0[1]
    for _ in range(4):
        grads = _grads(moved, gen)
        got = opt.update_with_ema(grads, a, params, ema, DECAY)
        want = plain_chain(opt, grads, b, params, ema)
        assert _unequal(got, want) == []
        a, b = got[1], want[1]
    assert all(torch.equal(t, k) for (_, t), k in zip(
        flatten_tree((params, ema)), keep))


def _seal_student(dev, family):
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.seal.mappers import build_mapper
    from seal3d_tpu_torch.seal.trainer import PretrainConfig, SealTrainer
    from seal3d_tpu_torch.train.trainer import TrainConfig

    torch.manual_seed(5)
    if family == "ngp":
        mod, cfg = ngp, ngp.NGPConfig(grid_backend="bucket")
    else:
        mod, cfg = tensorf, tensorf.TensoRFConfig(resolution=(48, 48, 48))
    teacher = mod.init(cfg, device=dev)
    st = SealTrainer(mod, cfg, RenderOptions(bound=1.0, dt_gamma=0.0,
                                             min_near=0.05, max_steps=512),
                     TrainConfig(num_rays=4096), build_mapper(BBOX),
                     teacher_params=teacher,
                     teacher_bitfield=torch.zeros(128**3 // 8,
                                                  dtype=torch.uint8),
                     seed=0, device=dev)
    st.init_state()
    st.init_pretraining(PretrainConfig(batch_size=2**15,
                                       local_point_step=0.04,
                                       surrounding_point_step=0.08,
                                       global_point_step=0.2))
    src = next(iter(st.pretrain_data.values()))
    batch = {k: src[k][0] for k in ("points", "dirs", "sigma", "color",
                                    "weight")}
    return st, batch


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ngp", "tensorf"])
def test_pretrain_steps_do_not_sync(cuda_device, family):
    st, batch = _seal_student(cuda_device, family)
    st._pretrain_step(batch)          # builds and loads the kernels
    torch.cuda.synchronize()
    n = fused.adam_ema.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [st._pretrain_step(batch) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused.adam_ema.launches - n == 3
    assert all(math.isfinite(float(x)) for x in losses)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ngp", "tensorf"])
def test_pretrain_step_leaves_the_state_passed_in(cuda_device, family):
    st, batch = _seal_student(cuda_device, family)
    before = st.state
    opt_before = st._pre_opt_state
    copies = [{k: v.clone() for k, v in flatten_tree(t)}
              for t in (before.params, before.ema_params, opt_before)]
    st._pretrain_step(batch)
    for t, want in zip((before.params, before.ema_params, opt_before),
                       copies):
        got = dict(flatten_tree(t))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert ([k for k, _ in flatten_tree(st._pre_opt_state[0].mu)]
            == [k for k, _ in flatten_tree(opt_before[0].mu)])
    assert ([k for k, _ in flatten_tree(st._pre_opt_state)]
            == [k for k, _ in flatten_tree(opt_before)])
    moved = [k for k, v in flatten_tree(st.state.params)
             if not torch.equal(v, dict(flatten_tree(before.params))[k])]
    assert moved and int(st._pre_opt_state[0].count) == 1
