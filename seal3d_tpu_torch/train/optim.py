"""The trainer's optimizer (port of the optax chain of
seal3d_tpu/train/trainer.py:246-253), as plain tensor code:

    optax.chain(scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
                scale_by_schedule(lambda s: -lr * 0.1 ** min(s / max_steps, 1)),
                [_scale_non_encoder(net_scale)])

The third stage, the D-NeRF family's MLP learning rate (`lr_net_scale`),
multiplies the updates of every top-level key whose name lacks "encoder"
by `net_scale`; it is in the chain only where net_scale != 1, and its
state is empty. The state is a tuple shaped like optax's, so its checkpoint
keys are the reference's (`opt_state/0/count`, `opt_state/0/mu/...`,
`opt_state/0/nu/...`, `opt_state/1/count`; the empty `opt_state/2` has no
leaf). Adam bias-corrects with its count after the increment; the schedule
reads its own count before the increment. Everything is float32 with int32
counts, as in the reference. `Optimizer.update_with_ema` runs the update,
its apply and the EMA over every parameter leaf as one launch of the fused
kernel (ops/adam.py) on CUDA tensors.

`GroupedOptimizer` is optax.multi_transform: a labelling function names the
group of every leaf from its '/'-joined path, and each group has an
`Optimizer` or is frozen (zero updates). Its state has optax's tree shape
(`inner_states/<group>/inner_state/...`, the leaves of other groups absent),
so its checkpoint keys are the reference's too. `tensorf_optimizer` is the
TensoRF family's (port of seal3d_tpu/train/tensorf_trainer.py
`tensorf_optimizer`), `cc_optimizer` the CCNeRF family's (port of
seal3d_tpu/train/cc_trainer.py `cc_optimizer`).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from seal3d_tpu_torch.ops.adam import adam_ema
from seal3d_tpu_torch.train.checkpoint import (fill_tree, flatten_tree,
                                               map_tree, map_trees,
                                               tree_leaves)


class AdamState(NamedTuple):
    count: torch.Tensor  # [] int32, updates so far
    mu: Any              # first moments, shaped like params
    nu: Any              # second moments


class ScheduleState(NamedTuple):
    count: torch.Tensor  # [] int32


class EmptyState(NamedTuple):
    """optax.EmptyState: the state of a stage that keeps none."""


class Optimizer:
    """Adam + the reference's LR decay lr * 0.1^min(step / max_steps, 1),
    then, where net_scale != 1, the updates of the non-encoder keys times
    net_scale. With max_steps None the rate is constant and the second
    stage keeps no state: optax.adam(lr, b1, b2, eps) (the SDF trainer's,
    with b2 0.999 and eps 1e-8)."""

    def __init__(self, lr: float, max_steps: Optional[float], b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-15, net_scale: float = 1.0):
        self.lr, self.max_steps = lr, max_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.net_scale = net_scale
        self._spare = []    # update_with_ema's two output sets

    def init(self, params):
        dev = flatten_tree(params)[0][1].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        zeros = map_tree(params, lambda _, p: torch.zeros_like(p))
        state = (AdamState(count=zero, mu=zeros,
                           nu=map_tree(zeros, lambda _, z: z.clone())),
                 EmptyState() if self.max_steps is None
                 else ScheduleState(count=zero.clone()))
        return state + (EmptyState(),) if self.net_scale != 1.0 else state

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule's step size (positive) at int32 `count`."""
        frac = (count.to(torch.float32) / self.max_steps).clamp(max=1.0)
        return self.lr * torch.pow(torch.tensor(0.1, device=count.device), frac)

    @torch.no_grad()
    def update(self, grads, state):
        """(updates, new state), as optax's chain.update(grads, state)."""
        adam, sched = state[:2]
        b1, b2 = self.b1, self.b2
        mu = map_trees(lambda m, g: (1 - b1) * g + b1 * m, adam.mu, grads)
        nu = map_trees(lambda v, g: (1 - b2) * (g * g) + b2 * v, adam.nu, grads)
        count = adam.count + 1
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=cf.device), cf)
        step = (-self.lr if self.max_steps is None
                else -self.learning_rate(sched.count))
        updates = map_trees(
            lambda m, v: step * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)),
            mu, nu)
        if self.net_scale != 1.0:
            updates = map_tree(updates, lambda k, u: (
                u if "encoder" in k.split("/")[0] else u * self.net_scale))
        sched = (sched if self.max_steps is None
                 else ScheduleState(count=sched.count + 1))
        return updates, (AdamState(count=count, mu=mu, nu=nu), sched,
                         *state[2:])

    @torch.no_grad()
    def update_with_ema(self, grads, state, params: dict, ema, decay: float):
        """`update`, `apply_updates` and the EMA e * decay + p * (1 - decay)
        over every leaf of `ema` as one launch of the fused kernel
        (ops/adam.py) on CUDA tensors: grads holds the moved top-level
        entries of `params`, the others stay as they are -> (new params, new
        state, new EMA), the plain chain's bit for bit. No tensor passed in
        is written; the results go to one of two sets that alternate from
        call to call (ops/adam.py), so a caller keeps a result only while it
        passes it on. The kernel has no CPU mode: CPU callers run the plain
        chain."""
        flat_g = tree_leaves(grads)
        adam, sched = state[:2]
        keys = list(grads)
        frozen = [k for k in ema if k not in grads]
        # leaves in one order for every tree: by the top-level keys of
        # grads, each entry in its own (shared) structure
        scales = (None if self.net_scale == 1.0 else
                  [1.0 if "encoder" in k else self.net_scale
                   for k in keys for _ in tree_leaves(grads[k])])
        out = adam_ema(
            tree_leaves([params[k] for k in keys]), flat_g,
            tree_leaves([adam.mu[k] for k in keys]),
            tree_leaves([adam.nu[k] for k in keys]),
            tree_leaves([ema[k] for k in keys]),
            tree_leaves([params[k] for k in frozen]),
            tree_leaves([ema[k] for k in frozen]), count=adam.count,
            sched_count=None if self.max_steps is None else sched.count,
            lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps, decay=decay,
            max_steps=self.max_steps, scales=scales, spare=self._spare)
        params = {**params, **fill_tree({k: params[k] for k in keys},
                                        out.params)}
        ema = {**ema, **fill_tree({k: ema[k] for k in keys + frozen},
                                  out.ema + out.frozen_ema)}
        mu = fill_tree({k: adam.mu[k] for k in keys}, out.mu)
        nu = fill_tree({k: adam.nu[k] for k in keys}, out.nu)
        if self.max_steps is not None:
            sched = ScheduleState(count=out.sched_count)
        return params, (AdamState(count=out.count, mu=mu, nu=nu), sched,
                        *state[2:]), ema


@torch.no_grad()
def apply_updates(params, updates):
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return map_trees(lambda p, u: p + u, params, updates)


class MaskedState(NamedTuple):
    """optax.masked's state: one group's inner state (empty when frozen)."""
    inner_state: Any


class PartitionState(NamedTuple):
    """optax.multi_transform's state: {group: MaskedState}."""
    inner_states: dict


class GroupedOptimizer:
    """optax.multi_transform: `label(path)` names the group of the leaf at
    each '/'-joined path (`encoder`, `objects/0/vec_color/1/U/2`); `groups`
    maps a group to its Optimizer, or to None for a frozen group
    (optax.set_to_zero: a zero update, no state). A group's Optimizer sees
    the params tree with the other groups' leaves set to None, as
    optax.masked hides them."""

    def __init__(self, groups: Mapping[str, Optional[Optimizer]],
                 label: Callable[[str], str]):
        self.groups = dict(groups)
        self.label = label

    def _part(self, tree, group: str):
        return map_tree(tree, lambda k, v: v if self.label(k) == group
                        else None)

    def init(self, params):
        return PartitionState({
            g: MaskedState(() if opt is None
                           else opt.init(self._part(params, g)))
            for g, opt in self.groups.items()})

    @torch.no_grad()
    def update(self, grads, state):
        """(updates shaped like grads, new state)."""
        updates, inner = {}, {}
        for g, opt in self.groups.items():
            part = self._part(grads, g)
            if opt is None:
                u = map_tree(part, lambda _, t: torch.zeros_like(t))
                inner[g] = MaskedState(())
            else:
                u, s = opt.update(part, state.inner_states[g].inner_state)
                inner[g] = MaskedState(s)
            updates.update(flatten_tree(u))
        return (map_tree(grads, lambda k, _: updates[k]),
                PartitionState(inner))


def tensorf_optimizer(max_steps: int, lr_factor: float = 2e-2,
                      lr_net: float = 1e-3) -> GroupedOptimizer:
    """The TensoRF family's optimizer: the `*_mat` / `*_vec` factors at
    lr_factor, `basis_mat`, `color_net` and `bg_net` at lr_net, `aabb`
    frozen; each group Adam(0.9, 0.99, 1e-15) with the decay
    lr * 0.1^min(step / max_steps, 1)."""

    def label(path: str) -> str:
        key = path.split("/")[0]
        if key in ("basis_mat", "color_net", "bg_net"):
            return "net"
        return "frozen" if key == "aabb" else "factor"

    return GroupedOptimizer({"factor": Optimizer(lr_factor, max_steps),
                             "net": Optimizer(lr_net, max_steps),
                             "frozen": None}, label)


CC_FAMILIES = ("vec_density", "mat_density", "vec_color", "mat_color")


def cc_optimizer(max_steps: int, lr_factor: float = 2e-2,
                 lr_net: float = 1e-3) -> GroupedOptimizer:
    """The CCNeRF family's optimizer: in every object the rank groups'
    factors (`objects/<i>/<family>/<k>/U/<j>`) and `bg_mat` at lr_factor,
    their `S` weights and `bg_S` at lr_net, everything else (`aabb`, `T`,
    `R`) frozen; each group Adam(0.9, 0.99, 1e-15) with the decay
    lr * 0.1^min(step / max_steps, 1)."""

    def label(path: str) -> str:
        parts = path.split("/")
        if parts[0] == "objects" and len(parts) >= 5 \
                and parts[2] in CC_FAMILIES:
            return "factor" if parts[4] == "U" else "net"
        return {"bg_mat": "factor", "bg_S": "net"}.get(parts[0], "frozen")

    return GroupedOptimizer({"factor": Optimizer(lr_factor, max_steps),
                             "net": Optimizer(lr_net, max_steps),
                             "frozen": None}, label)
