"""Adam and the EMA of a training step as one hand-written CUDA launch
(csrc/adam_ema.cu, whose note says what it computes and what bounds it).

`adam_ema` takes flat lists of leaves: the moved leaves with their
gradients, moments and EMA, and the EMA-only leaves (parameters the step
does not move, whose EMA still decays towards them), and returns the new
parameters, moments, EMA and counts. Nothing passed in is written, so a
caller that keeps an earlier state keeps it whole. The result is the plain
chain's (train/optim.py `Optimizer.update`, `apply_updates`, then
`e * d + p * (1 - d)` over every leaf) bit for bit on the card: the same
operations in the same order, each rounded once.

The kernel runs for CUDA tensors alone; there is no CPU mode and no
fallback (CPU callers run the plain chain of train/optim.py). It adapts to
the leaves by their lengths, with no option: the host builds a table of
each leaf's first chunk (`chunk_table`) once a set of leaf shapes, and each
block of the launch takes one chunk. A launch takes up to MAX_LEAVES leaves
(the Seal-3D trees hold 7 and 17); more are refused.

Outputs. Without `spare` every output is a fresh tensor. A caller that
steps one state after another passes a list it keeps (`spare`): the call
keeps there the two output sets it wrote last, and writes into one that
holds no tensor passed in (else into a fresh set, which takes the older
one's place). So the two sets alternate, a step allocates nothing, and no
input is written; a result is written over two calls later unless that
call is given it, so such a caller keeps a result only while it passes it
on.

Counters, process-wide and on the host (no device sync): the launches in
`adam_ema.launches`, and the elements and bytes served, `moved_elements` /
`moved_bytes` (36 B an element: p, g, m, v and e read, four written) and
`ema_only_elements` / `ema_only_bytes` (12 B: e and p read, e written).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from seal3d_tpu_torch.runtime.kernels import Kernel

MAX_LEAVES = 32     # leaves a launch takes (csrc/adam_ema.cu kMaxLeaves)
CHUNK = 2048        # elements a block takes (kChunk)
MOVED_BYTES = 36    # fp32 bytes an element of a moved leaf moves
EMA_ONLY_BYTES = 12

# the kernel's table, laid out as csrc/adam_ema.cu's AdamEMAArgs: pointers
# [9, MAX_LEAVES] (p, g, m, v, e in; p', m', v', e' out), lengths, first
# chunks, per-leaf rate and scale, the scalars b1, 1-b1, b2, 1-b2, eps, d,
# 1-d, 1/max_steps, and the flags leaves, schedule, CHUNK
_ARGS = np.dtype([("ptr", np.uint64, (9, MAX_LEAVES)),
                  ("n", np.int64, (MAX_LEAVES,)),
                  ("first_chunk", np.int64, (MAX_LEAVES + 1,)),
                  ("lr", np.float32, (MAX_LEAVES,)),
                  ("scale", np.float32, (MAX_LEAVES,)),
                  ("hyper", np.float32, (8,)),
                  ("flags", np.int32, (3,))], align=True)
assert _ARGS.itemsize == 3128

# table, count, sched, count_out, sched_out, stream
_KERNEL = Kernel("adam_ema", "ppppp s")

moved_elements = 0
moved_bytes = 0
ema_only_elements = 0
ema_only_bytes = 0


class AdamEMA(NamedTuple):
    """What `adam_ema` returns: lists in the order of its arguments."""
    params: list            # p' of the moved leaves
    mu: list
    nu: list
    ema: list               # e' of the moved leaves
    frozen_ema: list        # e' of the EMA-only leaves
    count: torch.Tensor     # [] int32, the Adam count after the step
    sched_count: Optional[torch.Tensor]   # the schedule's, None without


def chunk_table(sizes: Sequence[int]) -> list:
    """Each leaf's first chunk of CHUNK elements, then the total: block b of
    the launch takes chunk b."""
    out = [0]
    for n in sizes:
        out.append(out[-1] + -(-int(n) // CHUNK))
    return out


class _Plan:
    """The launch for one set of leaf shapes (the moved first): its table
    (numpy, laid out as the kernel's struct) and the table slots of a
    call's pointers."""

    def __init__(self, shapes: tuple, n_moved: int):
        sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        n, m = len(sizes), n_moved
        if n > MAX_LEAVES:
            raise ValueError(f"adam_ema: {n} leaves, more than a launch "
                             f"takes ({MAX_LEAVES})")
        self.moved, self.ema_only = sum(sizes[:m]), sum(sizes[m:])
        self.args = np.zeros((), dtype=_ARGS)
        self.addr = self.args.ctypes.data     # the host address passed
        self.args["n"][:n] = sizes
        self.args["first_chunk"][:n + 1] = chunk_table(sizes)
        self.args["flags"][0], self.args["flags"][2] = n, CHUNK
        # a call's pointers come as one list: p | EMA-only p | g | m | v | e
        # | EMA-only e, then p' | m' | v' | e' | EMA-only e', the table's
        # rows 0-8 in turn; an EMA-only leaf fills rows 0, 4 and 8 alone
        # (its other slots stay null)
        rows = (n, m, m, m, n, m, m, m, n)
        self.pos = np.asarray([r * MAX_LEAVES + i
                               for r, k in enumerate(rows) for i in range(k)])
        self.ptr = self.args["ptr"].reshape(-1)
        self.written = None     # the rate, scales and scalars last written


_plans = {}


def _plan(shapes: tuple, n_moved: int) -> _Plan:
    """The launch for leaves of these shapes (the moved first), cached."""
    plan = _plans.get((shapes, n_moved))
    if plan is None:
        plan = _plans[(shapes, n_moved)] = _Plan(shapes, n_moved)
    return plan


class _Outputs(NamedTuple):
    """One set of a call's outputs."""
    plan: _Plan
    tensors: list           # p' | m' | v' | e' | EMA-only e'
    count: torch.Tensor
    sched: Optional[torch.Tensor]
    addrs: list             # the tensors' addresses, in their order
    held: frozenset         # every address of the set, the counts' too


def _free(spare: list, plan: _Plan, taken: set) -> Optional[_Outputs]:
    """A set of `spare` for `plan` that holds no address of `taken`."""
    return next((o for o in spare
                 if o.plan is plan and taken.isdisjoint(o.held)), None)


def adam_ema(params, grads, mu, nu, ema, frozen=(), frozen_ema=(), *,
             count: torch.Tensor, sched_count: Optional[torch.Tensor],
             lr: float, b1: float, b2: float, eps: float, decay: float,
             max_steps: Optional[float] = None, scales=None,
             spare: Optional[list] = None) -> AdamEMA:
    """One step of Adam and the EMA on the card. params, grads, mu, nu, ema:
    the moved leaves' lists; frozen, frozen_ema: the EMA-only leaves' (their
    parameters and EMA); count: Adam's [] int32 count, sched_count the
    schedule's (None for a constant rate, as `max_steps` None); scales None
    or one factor a moved leaf (net_scale); spare: the caller's list of
    output sets (module note), None for fresh outputs. Counted in
    `adam_ema.launches`."""
    global moved_elements, moved_bytes, ema_only_elements, ema_only_bytes
    dev = count.device
    if dev.type != "cuda":
        raise ValueError(f"adam_ema: the kernel takes CUDA tensors; got "
                         f"{dev} (the plain chain is train/optim.py's)")
    n_moved, n_frozen = len(params), len(frozen)
    shapes = [t.shape for t in params]
    f_shapes = [t.shape for t in frozen]
    # the parameters and gradients f32 on the card; the moments and EMA,
    # which the optimizer made from them, shaped like them
    if ({(t.dtype, t.get_device()) for t in (*params, *grads, *frozen)}
            - {(torch.float32, dev.index)}):
        raise ValueError(f"adam_ema: every leaf must be f32 on {dev}")
    if any([t.shape for t in ls] != shapes for ls in (grads, mu, nu, ema)) \
            or [t.shape for t in frozen_ema] != f_shapes:
        raise ValueError("adam_ema: one gradient, moment pair and EMA a "
                         "moved leaf, one EMA an EMA-only leaf, each shaped "
                         "like its parameter")
    if (sched_count is None) != (max_steps is None):
        raise ValueError("adam_ema: a schedule count goes with max_steps")
    if count.dtype != torch.int32 or (sched_count is not None and (
            sched_count.dtype != torch.int32 or sched_count.device != dev)):
        raise ValueError("adam_ema: the counts must be int32 on the card")

    plan = _plan((*shapes, *f_shapes), n_moved)
    ins = [t.contiguous() for t in (*params, *frozen, *grads, *mu, *nu,
                                    *ema, *frozen_ema)]
    ptrs = [t.data_ptr() for t in ins]
    out = None
    if spare is not None:
        taken = {*ptrs, count.data_ptr()}
        if sched_count is not None:
            taken.add(sched_count.data_ptr())
        out = _free(spare, plan, taken)
    if out is None:
        tensors = [torch.empty_like(t) for t in ins[:n_moved] * 4
                   + ins[n_moved:n_moved + n_frozen]]
        count_out = torch.empty_like(count)
        sched_out = (None if sched_count is None
                     else torch.empty_like(sched_count))
        addrs = [t.data_ptr() for t in tensors]
        held = {*addrs, count_out.data_ptr()}
        if sched_out is not None:
            held.add(sched_out.data_ptr())
        out = _Outputs(plan, tensors, count_out, sched_out, addrs,
                       frozenset(held))
        if spare is not None:
            spare.append(out)
            del spare[:-2]
    # the float PyTorch casts the Python double to (the table's fields are
    # float32: numpy rounds each double once, as a C cast does), and the
    # reciprocal its CUDA division by a host scalar multiplies by
    scales = ((1.0,) * n_moved if scales is None else tuple(scales)) \
        + (1.0,) * n_frozen
    hyper = (lr, b1, 1 - b1, b2, 1 - b2, eps, decay, 1.0 - decay,
             1.0 if max_steps is None else max_steps, sched_count is not None)
    if plan.written != (scales, hyper):
        plan.args["lr"][:] = lr
        plan.args["scale"][:len(scales)] = scales
        plan.args["hyper"][:7] = hyper[1:8]
        plan.args["hyper"][7] = np.float32(1.0) / np.float32(hyper[8])
        plan.args["flags"][1] = hyper[9]
        plan.written = (scales, hyper)
    plan.ptr[plan.pos] = ptrs + out.addrs
    _KERNEL.launch(adam_ema, plan.addr, count, sched_count, out.count,
                   out.sched)
    moved_elements += plan.moved
    moved_bytes += MOVED_BYTES * plan.moved
    ema_only_elements += plan.ema_only
    ema_only_bytes += EMA_ONLY_BYTES * plan.ema_only
    o, m = out.tensors, n_moved
    return AdamEMA(o[:m], o[m:2 * m], o[2 * m:3 * m], o[3 * m:4 * m],
                   o[4 * m:], out.count, out.sched)


adam_ema.launches = 0
