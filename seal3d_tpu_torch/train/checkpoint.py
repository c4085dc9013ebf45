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

`export_torch_ngp` / `import_torch_ngp` write and read the NGP params as a
torch `.pth` in the upstream torch-ngp / Seal-3D state-dict naming (port of
the reference's functions of the same names), converting padded-level table
layouts to the reference's native one and back; `export_torch_tensorf` /
`import_torch_tensorf` do the same for TensoRF (VM or CP) params, with the
`resolution` metadata the upstream loader re-instantiates from, and
`export_torch_ccnerf` / `import_torch_ccnerf` for CCNeRF's object 0, with
its `resolution` and cumulative `rank_*` metadata.

Every family's params tree moves between the packages by path: NGP's,
TensoRF's, D-NeRF's (`encoder` and `deform_net` / `basis_net` /
`ambient_net`, `sigma_net`, `color_net`), CCNeRF's (`objects/<i>/<family>/
<group>/U/<axis>`, `.../S`, `aabb`, `T`, `R`) and SDF's (`encoder`, `net`).

A TensoRF state changes its factor shapes when it is upsampled or shrunk,
so its load takes the file's shapes (`take_shapes=True`, what the
reference's `load_state` does for every state); NGP's keeps the strict
shape check.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Any, Mapping

import numpy as np
import torch

from seal3d_tpu_torch.models import tensorf
from seal3d_tpu_torch.ops.hashgrid import convert_table_layout


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


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of a tree, in `flatten_tree`'s order, without
    their paths (the cheap walk for a per-step hot path)."""
    out = []
    _collect(tree, out)
    return out


def _collect(tree, out: list):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out)
    elif tree is not None:
        raise TypeError(f"unsupported checkpoint leaf {type(tree)}")


def fill_tree(tree: Any, leaves) -> Any:
    """The same tree with its tensor leaves replaced by `leaves`, in
    `tree_leaves`'s order (`map_tree` without the paths)."""
    return _fill(tree, iter(leaves))


def _fill(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _fill(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, it) for v in tree]
    if isinstance(tree, tuple):
        vals = [_fill(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def params_from_jax(tree: Any, device=None) -> Any:
    """A JAX params tree (dicts/lists of arrays, e.g. `np.asarray`-mapped
    `ngp.init(...)`) -> the same tree of torch tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def level_shard(table: torch.Tensor, grid_cfg, n_model: int,
                j: int) -> torch.Tensor:
    """Rows of model rank j's levels [j*L/n, (j+1)*L/n) of a uniform
    [L*T, F] table (levels padded to T: shard_levels, 'halo', 'pallas')."""
    per = grid_cfg.num_levels // n_model
    rows = per * 2**grid_cfg.log2_hashmap_size
    if per * n_model != grid_cfg.num_levels or table.shape[0] != \
            grid_cfg.num_levels * 2**grid_cfg.log2_hashmap_size:
        raise ValueError(f"level_shard: {tuple(table.shape)} is not a uniform "
                         f"stack of {grid_cfg.num_levels} levels that divide "
                         f"into {n_model} shards")
    return table[j * rows:(j + 1) * rows]


def state_to_arrays(state: Any, full: bool = True) -> dict:
    """{'/'-joined path: numpy array} of every tensor of `state`; full=False
    drops the optimizer state (the reference's light checkpoint)."""
    if not full:
        state = state._replace(opt_state=None)
    return {k: v.detach().cpu().numpy() for k, v in flatten_tree(state)}


def state_from_arrays(arrays: Mapping[str, np.ndarray], template: Any,
                      take_shapes: bool = False) -> Any:
    """Fill the structure (devices, dtypes) of `template` from arrays keyed
    by path; keys missing from `arrays` keep the template's value, with a
    warning (non-strict, like the reference). A shape that differs from the
    template's raises, unless take_shapes (the file's shape is taken)."""
    missing = []

    def pick(key, leaf):
        if key not in arrays:
            missing.append(key)
            return leaf
        arr = np.asarray(arrays[key])
        if arr.shape != tuple(leaf.shape) and not take_shapes:
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


def load_state(path: str, template: Any, take_shapes: bool = False) -> Any:
    """Load a `.npz` into the structure (and devices) of `template`."""
    with np.load(path) as data:
        return state_from_arrays({k: data[k] for k in data.files}, template,
                                 take_shapes=take_shapes)


def prune_checkpoints(directory: str, name: str, keep: int = 2):
    """Delete all but the newest `keep` step checkpoints of `name`."""
    files = sorted(glob.glob(os.path.join(directory, f"{name}_step*.npz")))
    for f in files[:-keep]:
        os.remove(f)


def latest_checkpoint(directory: str, name: str):
    files = sorted(glob.glob(os.path.join(directory, f"{name}_step*.npz")))
    return files[-1] if files else None


_TORCH_NGP_LAYER = re.compile(r"(sigma_net|color_net|bg_net)\.(\d+)\.weight")


def _native(grid_cfg):
    """The reference's (xla) layout of `grid_cfg`'s levels, or None when
    `grid_cfg` already has it (or is not given)."""
    if grid_cfg is None or grid_cfg.backend not in ("pallas", "halo"):
        return None
    return dataclasses.replace(grid_cfg, backend="xla")


def export_torch_ngp(path: str, params: dict, step: int = 0, grid_cfg=None):
    """Write NGP params as a reference-compatible `.pth`: `encoder.embeddings`
    and `encoder_color.embeddings` [rows, F] in the native level layout
    (tables of a padded-level `grid_cfg` are re-packed), the background
    net's `encoder_bg.embeddings` (native already: its grid is on `xla`)
    where the params have one, and the bias-free Linears
    `{sigma,color,bg}_net.{i}.weight` [out, in] (the params store
    [in, out]). For 'halo' configs the exported entries keep wrap indexing,
    which only this package and the JAX one read."""
    native = _native(grid_cfg)

    def table(t):
        t = t.detach().cpu()
        if native is not None:
            t = convert_table_layout(t, grid_cfg, native)
        return t.contiguous().clone()

    sd = {}
    for enc in ("encoder", "encoder_color"):
        if enc in params:
            sd[f"{enc}.embeddings"] = table(params[enc])
    if "encoder_bg" in params:
        sd["encoder_bg.embeddings"] = params["encoder_bg"].detach().cpu().clone()
    for net in ("sigma_net", "color_net", "bg_net"):
        for i, layer in enumerate(params.get(net, ())):
            sd[f"{net}.{i}.weight"] = layer["w"].detach().cpu().T.contiguous()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": sd, "global_step": step, "epoch": 0, "stats": {}},
               path)


def import_torch_ngp(pth_path: str, params: dict, grid_cfg=None) -> dict:
    """A reference torch-ngp / Seal-3D NGP `.pth` mapped onto a copy of the
    params tree `params` (devices and dtypes kept). Reference tables use the
    native level layout; pass `grid_cfg` (the HashGridConfig of `params`) so
    tables of a padded-level config are re-packed, their padding rows
    zero-filled. The background net's `encoder_bg` and `bg_net` are read
    where `params` has them."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    out = map_tree(params, lambda _, t: t)      # a new tree, the same leaves
    native = _native(grid_cfg)

    def like(v, ref):
        return v.detach().to(device=ref.device, dtype=ref.dtype).contiguous()

    def table(v, ref):
        if native is not None and tuple(v.shape) != tuple(ref.shape):
            v = convert_table_layout(v.detach().float(), native, grid_cfg)
        return like(v, ref)

    for k, v in sd.items():
        for enc in ("encoder_color", "encoder_bg", "encoder"):
            if k.endswith(f"{enc}.embeddings") and enc in out:
                out[enc] = (like(v, out[enc]) if enc == "encoder_bg"
                            else table(v, out[enc]))
                break
        else:
            m = _TORCH_NGP_LAYER.search(k)
            if m:
                net, i = m.group(1), int(m.group(2))
                if net in out and i < len(out[net]):
                    out[net][i]["w"] = like(v.T, out[net][i]["w"])
    return out


def tensorf_resolution(params: dict) -> list:
    """Per-axis grid resolution of TensoRF params, from the sigma lines
    (line i spans world axis VEC_IDS[i])."""
    res = [0, 0, 0]
    for i in range(3):
        res[tensorf.VEC_IDS[i]] = int(params["sigma_vec"][i].shape[1])
    return res


def export_torch_tensorf(path: str, params: dict, step: int = 0):
    """Write TensoRF (VM or CP) params as a reference-compatible `.pth`:
    mats `{sigma,color}_mat.{i}` [1, R, H, W], vecs `{sigma,color}_vec.{i}`
    [1, R, D, 1], `basis_mat.weight` and the bias-free Linears
    `{color,bg}_net.{i}.weight` [out, in] (the params store [in, out]),
    `bg_mat` [1, R, H, W], `aabb_train` / `aabb_infer`, and the
    `resolution` metadata."""
    def t(v):
        return v.detach().cpu().contiguous().clone()

    sd = {}
    for nm in ("sigma", "color"):
        for i, m in enumerate(params.get(f"{nm}_mat") or []):
            sd[f"{nm}_mat.{i}"] = t(m[None])
        for i, v in enumerate(params[f"{nm}_vec"]):
            sd[f"{nm}_vec.{i}"] = t(v[None, ..., None])
    sd["basis_mat.weight"] = t(params["basis_mat"][0]["w"].T)
    for net in ("color_net", "bg_net"):
        for i, layer in enumerate(params.get(net, ())):
            sd[f"{net}.{i}.weight"] = t(layer["w"].T)
    if "bg_mat" in params:
        sd["bg_mat"] = t(params["bg_mat"][None])
    sd["aabb_train"] = t(params["aabb"])
    sd["aabb_infer"] = t(params["aabb"])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": sd, "resolution": tensorf_resolution(params),
                "global_step": step, "epoch": 0, "stats": {}}, path)


def import_torch_tensorf(pth_path: str, cfg, device=None):
    """A reference TensoRF `.pth` -> (params on `device`, resolution),
    re-instantiated at the checkpoint's shape: a params tree is made at its
    `resolution` metadata (else the sigma lines' lengths) and filled from
    the state dict; keys the file lacks keep their init values.
    cfg.decomposition must match the file's (VM files carry `sigma_mat.*`):
    a mismatch raises ValueError."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    is_vm = any(k.endswith("sigma_mat.0") for k in sd)
    if is_vm != (cfg.decomposition == "vm"):
        raise ValueError(f"checkpoint decomposition ({'vm' if is_vm else 'cp'})"
                         f" != cfg.decomposition ({cfg.decomposition})")
    res = ckpt.get("resolution")
    if res is None:
        res = [0, 0, 0]
        for i in range(3):
            key = next(k for k in sd if k.endswith(f"sigma_vec.{i}"))
            res[tensorf.VEC_IDS[i]] = int(sd[key].shape[2])
    params = tensorf.init(cfg, generator=torch.Generator().manual_seed(0),
                          resolution=res)

    def f32(v):
        return v.detach().to(torch.float32).contiguous()

    for k, v in sd.items():
        base = k.split(".")
        name = base[-2] if base[-1].isdigit() else base[-1]
        if name in ("sigma_mat", "color_mat"):
            params[name][int(base[-1])] = f32(v[0])
        elif name in ("sigma_vec", "color_vec"):
            params[name][int(base[-1])] = f32(v[0, :, :, 0])
        elif k.endswith("basis_mat.weight"):
            params["basis_mat"][0]["w"] = f32(v.T)
        elif name == "bg_mat" and "bg_mat" in params:
            params["bg_mat"] = f32(v[0])
        elif k.endswith("aabb_train"):
            params["aabb"] = f32(v)
        else:
            m = _TORCH_NGP_LAYER.search(k)
            if m and m.group(1) in params:
                params[m.group(1)][int(m.group(2))]["w"] = f32(v.T)
    return map_tree(params, lambda _, t: t.to(device)), list(res)


# (family, U key, S key, rank metadata key) of the reference's CCNeRF .pth
_CC_FAMS = (("vec_density", "U_vec_density", "S_vec_density",
             "rank_vec_density"),
            ("mat_density", "U_mat_density", "S_mat_density",
             "rank_mat_density"),
            ("vec_color", "U_vec", "S_vec", "rank_vec"),
            ("mat_color", "U_mat", "S_mat", "rank_mat"))


def _cc_ranks(obj: dict, fam: str, cfg_ranks) -> tuple:
    """A family's cumulative rank metadata: the config's tuple where the
    live group sizes still match it (keeping its empty groups), else the
    cumsum of the live sizes (after finalize or compress)."""
    sizes = [int(g["U"][0].shape[0]) for g in obj[fam]]
    cfg_sizes = [int(d) for d in np.diff(np.asarray(cfg_ranks), prepend=0)
                 if d > 0]
    if cfg_sizes == sizes:
        return tuple(int(r) for r in cfg_ranks)
    return tuple(int(c) for c in np.cumsum(sizes))


def export_torch_ccnerf(path: str, params: dict, cfg, step: int = 0):
    """Write CCNeRF object 0 as a reference-compatible `.pth`: per group k
    and axis i `U_*.{3k+i}` [1, R, D, 1] (vector) or [1, R, H, W]
    (matrix), `S_*.{k}` [out_dim, R], `aabb_train` / `aabb_infer`, and the
    `resolution` and cumulative `rank_*` metadata its loader re-instantiates
    from."""
    obj = params["objects"][0]
    sd, meta = {}, {}
    for fam, un, sn, rn in _CC_FAMS:
        for k, g in enumerate(obj[fam]):
            for i in range(3):
                u = g["U"][i].detach().cpu()
                if fam.startswith("vec"):
                    u = u[:, :, None]
                sd[f"{un}.{3 * k + i}"] = u[None].contiguous().clone()
            sd[f"{sn}.{k}"] = g["S"].detach().cpu().contiguous().clone()
        meta[rn] = list(_cc_ranks(obj, fam, getattr(cfg, rn)))
    aabb = obj["aabb"].detach().cpu().clone()
    sd["aabb_train"] = aabb
    sd["aabb_infer"] = aabb.clone()
    fam0 = next(f for f, _, _, _ in _CC_FAMS if obj[f])
    u0 = obj[fam0][0]["U"]
    res = [0, 0, 0]
    for i in range(3):
        if fam0.startswith("vec"):
            res[tensorf.VEC_IDS[i]] = int(u0[i].shape[1])
        else:
            res[tensorf.MAT_IDS[i][0]] = int(u0[i].shape[2])
            res[tensorf.MAT_IDS[i][1]] = int(u0[i].shape[1])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": sd, "resolution": res, **meta, "global_step": step,
                "epoch": 0, "stats": {}}, path)


def import_torch_ccnerf(pth_path: str, cfg, device=None):
    """A reference CCNeRF `.pth` -> (params on `device`, new cfg): the field
    re-instantiated at the file's `resolution` and `rank_*` metadata, then
    its factors, weights and `aabb` filled in."""
    from seal3d_tpu_torch.models import ccnerf

    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    res = tuple(int(r) for r in ckpt["resolution"])
    new_cfg = dataclasses.replace(
        cfg, resolution=res,
        **{rn: tuple(int(r) for r in ckpt[rn])
           for _, _, _, rn in _CC_FAMS if rn in ckpt})
    params = ccnerf.init(new_cfg, generator=torch.Generator().manual_seed(0),
                         resolution=res)
    obj = params["objects"][0]

    def f32(v):
        return v.detach().to(torch.float32).contiguous()

    for fam, un, sn, _ in _CC_FAMS:
        for k, g in enumerate(obj[fam]):
            for i in range(3):
                u = sd[f"{un}.{3 * k + i}"][0]
                g["U"][i] = f32(u[:, :, 0] if fam.startswith("vec") else u)
            g["S"] = f32(sd[f"{sn}.{k}"])
    if "aabb_train" in sd:
        obj["aabb"] = f32(sd["aabb_train"])
    return map_tree(params, lambda _, t: t.to(device)), new_cfg
