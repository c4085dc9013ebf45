"""Checkpoints on the JAX package's `.npz` layout (port of
seal3d_tpu/train/checkpoint.py).

The reference writes one array per pytree leaf, keyed by its path joined
with '/' (`params/encoder`, `params/sigma_net/0/w`, `ema_params/...`,
`occ/bitfield`, `step`, and `opt_state/...` in full checkpoints). The port
reads and writes the same keys with numpy alone, so a checkpoint moves
between the two packages in either direction; keys the port has no state for
yet (`opt_state/...`) are ignored on load.
"""

from __future__ import annotations

import os
from typing import Any

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


def params_from_jax(tree: Any, device=None) -> Any:
    """A JAX params tree (dicts/lists of arrays, e.g. `np.asarray`-mapped
    `ngp.init(...)`) -> the same tree of torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def save_state(path: str, state: Any):
    """Write every tensor of `state` under its '/'-joined path."""
    arrays = {k: v.detach().cpu().numpy() for k, v in flatten_tree(state)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_state(path: str, template: Any) -> Any:
    """Load into the structure (and devices) of `template`; keys missing from
    the file keep the template's value, with a warning (non-strict, like the
    reference)."""
    missing = []
    with np.load(path) as data:
        def pick(key, leaf):
            if key not in data.files:
                missing.append(key)
                return leaf
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint {key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            return torch.from_numpy(arr).to(device=leaf.device,
                                            dtype=leaf.dtype)

        out = map_tree(template, pick)
    if missing:
        print(f"[checkpoint] missing keys kept from template: {missing[:5]}"
              f"{'...' if len(missing) > 5 else ''}")
    return out


def latest_checkpoint(directory: str, name: str):
    import glob

    files = sorted(glob.glob(os.path.join(directory, f"{name}_step*.npz")))
    return files[-1] if files else None
