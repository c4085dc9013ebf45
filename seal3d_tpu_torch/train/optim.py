"""The trainer's optimizer (port of the optax chain of
seal3d_tpu/train/trainer.py:246-253), as plain tensor code:

    optax.chain(scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
                scale_by_schedule(lambda s: -lr * 0.1 ** min(s / max_steps, 1)))

The state is a tuple shaped like optax's, so its checkpoint keys are the
reference's (`opt_state/0/count`, `opt_state/0/mu/...`, `opt_state/0/nu/...`,
`opt_state/1/count`). The reference's optional third stage, the MLP LR
scale of the D-NeRF family (`lr_net_scale`), is not on the ported path.
Adam bias-corrects with
its count after the increment; the schedule reads its own count before the
increment. Everything is float32 with int32 counts, as in the reference.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from seal3d_tpu_torch.train.checkpoint import flatten_tree, map_tree, map_trees


class AdamState(NamedTuple):
    count: torch.Tensor  # [] int32, updates so far
    mu: Any              # first moments, shaped like params
    nu: Any              # second moments


class ScheduleState(NamedTuple):
    count: torch.Tensor  # [] int32


class Optimizer:
    """Adam + the reference's LR decay lr * 0.1^min(step / max_steps, 1)."""

    def __init__(self, lr: float, max_steps: int, b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-15):
        self.lr, self.max_steps = lr, max_steps
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        dev = flatten_tree(params)[0][1].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        zeros = map_tree(params, lambda _, p: torch.zeros_like(p))
        return (AdamState(count=zero, mu=zeros,
                          nu=map_tree(zeros, lambda _, z: z.clone())),
                ScheduleState(count=zero.clone()))

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule's step size (positive) at int32 `count`."""
        frac = (count.to(torch.float32) / self.max_steps).clamp(max=1.0)
        return self.lr * torch.pow(torch.tensor(0.1, device=count.device), frac)

    @torch.no_grad()
    def update(self, grads, state):
        """(updates, new state), as optax's chain.update(grads, state)."""
        adam, sched = state
        b1, b2 = self.b1, self.b2
        mu = map_trees(lambda m, g: (1 - b1) * g + b1 * m, adam.mu, grads)
        nu = map_trees(lambda v, g: (1 - b2) * (g * g) + b2 * v, adam.nu, grads)
        count = adam.count + 1
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=cf.device), cf)
        step = -self.learning_rate(sched.count)
        updates = map_trees(
            lambda m, v: step * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)),
            mu, nu)
        return updates, (AdamState(count=count, mu=mu, nu=nu),
                         ScheduleState(count=sched.count + 1))


@torch.no_grad()
def apply_updates(params, updates):
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return map_trees(lambda p, u: p + u, params, updates)
