"""Checkpoints on the JAX package's `.npz` layout (port of
seal3d_tpu/train/checkpoint.py).

The reference writes one array per pytree leaf, keyed by its path joined
with '/' (`params/encoder`, `params/sigma_net/0/w`, `ema_params/...`,
`occ/bitfield`, `step`, and the optax state `opt_state/0/count`,
`opt_state/0/mu/...`, `opt_state/0/nu/...`, `opt_state/1/count` in full
checkpoints). The port's `TrainState` and optimizer state (train/optim.py)
have the same tree shape, so its keys are the reference's: a checkpoint
moves between the two packages in either direction, through the `.npz`
file (`save_state` / `load_state`) or in memory as a dict of numpy arrays
keyed the same way (`state_to_arrays` / `state_from_arrays`).
"""

from __future__ import annotations

import glob
import os
from typing import Any, Mapping

import numpy as np
import torch


def flatten_tree(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts, lists/tuples, NamedTuples and
    tensors; None leaves have no entry (as in a JAX pytree)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"unsupported checkpoint leaf {type(tree)} at {prefix!r}")
    out = []
    for k, v in items:
        out.extend(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def map_tree(tree: Any, fn, prefix: str = ""):
    """The same tree with every tensor leaf replaced by fn(path, leaf)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    join = (lambda k: f"{prefix}/{k}" if prefix else str(k))
    if hasattr(tree, "_fields"):
        return type(tree)(*[map_tree(getattr(tree, f), fn, join(f))
                            for f in tree._fields])
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(v, fn, join(i)) for i, v in enumerate(tree))
    raise TypeError(f"unsupported checkpoint leaf {type(tree)} at {prefix!r}")


def map_trees(fn, *trees):
    """The first tree with every tensor leaf replaced by fn(leaf, *the
    leaves at the same path of the other trees)."""
    others = [dict(flatten_tree(t)) for t in trees[1:]]
    return map_tree(trees[0], lambda k, v: fn(v, *(o[k] for o in others)))


def params_from_jax(tree: Any, device=None) -> Any:
    """A JAX params tree (dicts/lists of arrays, e.g. `np.asarray`-mapped
    `ngp.init(...)`) -> the same tree of torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def state_to_arrays(state: Any, full: bool = True) -> dict:
    """{'/'-joined path: numpy array} of every tensor of `state`; full=False
    drops the optimizer state (the reference's light checkpoint)."""
    if not full:
        state = state._replace(opt_state=None)
    return {k: v.detach().cpu().numpy() for k, v in flatten_tree(state)}


def state_from_arrays(arrays: Mapping[str, np.ndarray], template: Any) -> Any:
    """Fill the structure (devices, dtypes) of `template` from arrays keyed
    by path; keys missing from `arrays` keep the template's value, with a
    warning (non-strict, like the reference)."""
    missing = []

    def pick(key, leaf):
        if key not in arrays:
            missing.append(key)
            return leaf
        arr = np.asarray(arrays[key])
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint {key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)

    out = map_tree(template, pick)
    if missing:
        print(f"[checkpoint] missing keys kept from template: {missing[:5]}"
              f"{'...' if len(missing) > 5 else ''}")
    return out


def save_state(path: str, state: Any, full: bool = True):
    """Write every tensor of `state` under its '/'-joined path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **state_to_arrays(state, full))


def load_state(path: str, template: Any) -> Any:
    """Load a `.npz` into the structure (and devices) of `template`."""
    with np.load(path) as data:
        return state_from_arrays({k: data[k] for k in data.files}, template)


def prune_checkpoints(directory: str, name: str, keep: int = 2):
    """Delete all but the newest `keep` step checkpoints of `name`."""
    files = sorted(glob.glob(os.path.join(directory, f"{name}_step*.npz")))
    for f in files[:-keep]:
        os.remove(f)


def latest_checkpoint(directory: str, name: str):
    files = sorted(glob.glob(os.path.join(directory, f"{name}_step*.npz")))
    return files[-1] if files else None
