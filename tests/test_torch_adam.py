"""The fused Adam and EMA launch's host side on the CPU (ops/adam.py): its
chunk table covers every element of every leaf exactly once at the
benchmark cells' leaf sets and at small and ragged ones, the table's layout
matches the kernel's struct, more than MAX_LEAVES leaves are refused, a
kept output set is written only where it holds no input; and
a CPU `SealTrainer._pretrain_step` runs the plain chain (`update`,
`apply_updates`, then the EMA), tensor for tensor; the
path-free tree walks it and the pretraining step use
(`checkpoint.tree_leaves`, `fill_tree`) keep `flatten_tree`'s order. The
kernel itself is held against the plain chain on the card in
tests/test_torch_adam_cuda.py.
"""

import math
import os
import re

import pytest
import torch

from seal3d_tpu_torch.models import ngp, tensorf
from seal3d_tpu_torch.train import checkpoint as ckpt
from seal3d_tpu_torch.ops import adam as fused
from seal3d_tpu_torch.train.checkpoint import flatten_tree, map_tree, map_trees
from seal3d_tpu_torch.train.optim import Optimizer, apply_updates

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "seal3d_tpu_torch", "csrc", "adam_ema.cu")


def chunk_ranges(table, sizes) -> list:
    """(leaf, start, end) of every block's elements, as csrc/adam_ema.cu
    reads `chunk_table`: block b's leaf is the last whose first chunk is
    <= b, its elements [k * CHUNK, min(n, (k + 1) * CHUNK)) of that leaf's
    chunk k."""
    out, k = [], 0
    for b in range(table[-1]):
        while k + 1 < len(sizes) and table[k + 1] <= b:
            k += 1
        start = (b - table[k]) * fused.CHUNK
        out.append((k, start, min(int(sizes[k]), start + fused.CHUNK)))
    return out


def _sizes(family):
    if family == "ngp":
        params = ngp.init(ngp.NGPConfig(grid_backend="bucket"),
                          device="meta")
        moved = ("encoder", "encoder_color")
    else:
        params = tensorf.init(tensorf.TensoRFConfig(
            resolution=(300, 300, 300)), device="meta")
        moved = tuple(k for k in params if k != "aabb")
    flat = flatten_tree(params)
    first = [t.numel() for k, t in flat if k.split("/")[0] in moved]
    return first + [t.numel() for k, t in flat
                    if k.split("/")[0] not in moved]


@pytest.mark.parametrize("sizes", [_sizes("ngp"), _sizes("tensorf"),
                                   [1, 3, 5, 0, 2048, 2049, 4096, 7],
                                   [2 * 2048 + 3]],
                         ids=["ngp", "tensorf", "small", "ragged"])
def test_chunk_table_covers_every_element_once(sizes):
    table = fused.chunk_table(sizes)
    ranges = chunk_ranges(table, sizes)
    assert len(ranges) == table[-1]
    seen = {k: [] for k in range(len(sizes))}
    for k, start, end in ranges:
        assert 0 <= start < end <= sizes[k] and end - start <= fused.CHUNK
        seen[k].append((start, end))
    for k, n in enumerate(sizes):
        spans = sorted(seen[k])
        assert sum(e - s for s, e in spans) == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert not spans or (spans[0][0], spans[-1][1]) == (0, n)


def test_cells_leaf_counts():
    """One launch a step at both cells: NGP 2 moved + 5 EMA-only leaves,
    TensoRF 16 + `aabb`."""
    for family, n in (("ngp", 7), ("tensorf", 17)):
        sizes = _sizes(family)
        assert len(sizes) == n <= fused.MAX_LEAVES
        plan = fused._plan(tuple((s,) for s in sizes), 2 if n == 7 else 16)
        assert int(plan.args["flags"][0]) == n
        assert list(plan.args["first_chunk"][:n + 1]) == \
            fused.chunk_table(sizes)


def test_table_slots_of_a_call():
    """Every pointer of a call (9 a moved leaf, 3 an EMA-only one) goes to
    a slot of its own, an EMA-only leaf's to rows p, e and e' alone; more
    leaves than a launch takes are refused."""
    n, m = fused.MAX_LEAVES, fused.MAX_LEAVES - 4
    sizes = [10 + i for i in range(n)]
    plan = fused._Plan(tuple((s,) for s in sizes), m)
    pos = plan.pos.tolist()
    assert len(pos) == 9 * m + 3 * (n - m) == len(set(pos))
    rows = [(p // fused.MAX_LEAVES, p % fused.MAX_LEAVES) for p in pos]
    assert all(r in (0, 4, 8) for r, i in rows if i >= m)
    assert sorted(i for r, i in rows if r == 0) == list(range(n))
    assert int(plan.args["flags"][0]) == n
    assert int(plan.args["flags"][2]) == fused.CHUNK
    assert list(plan.args["first_chunk"][:n + 1]) == fused.chunk_table(sizes)
    with pytest.raises(ValueError, match="more than a launch"):
        fused._Plan(tuple((1,) for _ in range(n + 1)), 1)


def test_a_free_output_set_holds_no_input():
    """`adam_ema` writes into a kept set only where none of its addresses
    is among the call's inputs, and only a set made for the same leaves."""
    plan = fused._Plan(((4,), (3,)), 1)
    other = fused._Plan(((5,),), 1)

    def outputs(p, addrs):
        return fused._Outputs(p, [], None, None, list(addrs),
                              frozenset(addrs))

    a, b, c = outputs(plan, (16, 32)), outputs(plan, (48, 64)), \
        outputs(other, (80,))
    assert fused._free([a, b], plan, {16, 99}) is b
    assert fused._free([a, b], plan, {64}) is a
    assert fused._free([a, b], plan, {16, 48}) is None
    assert fused._free([c], plan, set()) is None
    assert fused._free([], plan, set()) is None


def test_table_layout_matches_the_kernel():
    src = open(CU).read()
    assert int(re.search(r"kMaxLeaves = (\d+)", src).group(1)) \
        == fused.MAX_LEAVES
    assert "kChunk = 4LL * kThreads * kUnroll" in src
    threads = int(re.search(r"kThreads = (\d+)", src).group(1))
    unroll = int(re.search(r"kUnroll = (\d+)", src).group(1))
    assert 4 * threads * unroll == fused.CHUNK
    size = int(re.search(r"sizeof\(AdamEMAArgs\) == (\d+)", src).group(1))
    assert size == fused._ARGS.itemsize
    offsets = [fused._ARGS.fields[f][1] for f in fused._ARGS.names]
    assert offsets == sorted(offsets) and all(
        off % fused._ARGS.fields[f][0].base.itemsize == 0
        for f, off in zip(fused._ARGS.names, offsets))


def test_kernel_refuses_cpu_tensors():
    p = [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        fused.adam_ema(p, p, p, p, p, count=torch.zeros((), dtype=torch.int32),
                       sched_count=None, lr=0.1, b1=0.9, b2=0.99, eps=1e-15,
                       decay=0.95)


@pytest.mark.parametrize("family", ["ngp", "tensorf"])
def test_cpu_pretrain_step_runs_the_plain_chain(family, monkeypatch):
    """On CPU tensors `_pretrain_step` takes the plain chain (`update`,
    `apply_updates`, then the EMA, in its `pretrain.adam` and
    `pretrain.ema` ranges) and never the kernel's `update_with_ema`."""
    from test_torch_adam_cuda import DECAY, _seal_student

    st, batch = _seal_student(torch.device("cpu"), family)
    assert st.cfg.ema_decay == DECAY
    seen = []
    update = st._pre_opt.update

    def spy(grads, state):
        seen.append((grads, state))
        return update(grads, state)

    monkeypatch.setattr(st._pre_opt, "update", spy)
    monkeypatch.setattr(st._pre_opt, "update_with_ema", None)
    before = st.state
    st._pretrain_step(batch)
    (grads, state), = seen
    updates, want_state = update(grads, state)
    want = {**before.params, **apply_updates(
        {k: before.params[k] for k in grads}, updates)}
    want_ema = map_trees(lambda e, p: e * DECAY + p * (1.0 - DECAY),
                         before.ema_params, want)
    for got, ref in ((st.state.params, want), (st.state.ema_params, want_ema),
                     (st._pre_opt_state, want_state)):
        fa, fb = flatten_tree(got), flatten_tree(ref)
        assert [k for k, _ in fa] == [k for k, _ in fb]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def test_update_with_ema_refuses_cpu_tensors():
    params = {"encoder": torch.zeros(8)}
    opt = Optimizer(0.07, math.inf)
    with pytest.raises(ValueError, match="CUDA"):
        opt.update_with_ema(params, opt.init(params), params, params, 0.95)


def test_tree_leaves_and_fill_tree_follow_flatten_tree():
    """The optimizer's and the pretraining step's path-free walks take
    `flatten_tree`'s order and rebuild `map_tree`'s structure."""
    params = tensorf.init(tensorf.TensoRFConfig(resolution=(8, 8, 8)))
    state = Optimizer(0.01, 10, net_scale=0.5).init(params)
    for tree in (params, state):
        flat = flatten_tree(tree)
        assert [id(t) for t in ckpt.tree_leaves(tree)] == [
            id(t) for _, t in flat]
        doubled = [t * 2 for _, t in flat]
        want = map_tree(tree, lambda k, t: dict(zip(
            [k for k, _ in flat], doubled))[k])
        got = ckpt.fill_tree(tree, doubled)
        assert type(got) is type(want)
        assert [(k, id(t)) for k, t in flatten_tree(got)] == [
            (k, id(t)) for k, t in flatten_tree(want)]
