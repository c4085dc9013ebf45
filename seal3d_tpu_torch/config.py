"""Shared CLI surface (port of seal3d_tpu/config.py): the same arguments,
`-O` macro and defaults, plus `--device`. The reference's persistent XLA
compile cache is TPU machinery and has no counterpart here."""

from __future__ import annotations

import argparse

import torch

from seal3d_tpu_torch.render.renderer import RenderOptions
from seal3d_tpu_torch.train.trainer import TrainConfig


def common_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("path", type=str,
                   help="scene dir (transforms*.json) or 'synthetic'")
    p.add_argument("-O", action="store_true",
                   help="fast mode: occupancy march + halo (K1) encoder")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: the card unless 'cpu' is given")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test", action="store_true", help="test mode (no training)")
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--dense_render", action="store_true",
                   help="train through the dense (oracle) renderer")
    p.add_argument("--max_steps", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=128)
    p.add_argument("--upsample_steps", type=int, default=128)
    p.add_argument("--budget_per_ray", type=int, default=48)
    p.add_argument("--patch_size", type=int, default=1)
    p.add_argument("--bound", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=0.33)
    p.add_argument("--offset", type=float, nargs=3, default=[0, 0, 0])
    p.add_argument("--dt_gamma", type=float, default=1 / 128)
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--density_thresh", type=float, default=10.0)
    p.add_argument("--bg_radius", type=float, default=-1)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--error_map", action="store_true")
    p.add_argument("--color_space", type=str, default="srgb",
                   choices=["srgb", "linear"])
    p.add_argument("--grid_backend", type=str, default=None,
                   choices=["xla", "pallas", "bucket", "halo"],
                   help="hash-grid gather path: 'halo' = the K1 kernel over "
                        "the wrap gridtype (-O default), 'bucket' = the "
                        "hash-encode kernels over the reference's native "
                        "levels (T=2^19 default), 'pallas' = the same "
                        "kernels over levels padded to T (T=2^15 default), "
                        "'xla' = plain gathers")
    p.add_argument("--coarse_steps", type=int, default=64)
    p.add_argument("--num_candidates", type=int, default=None)
    p.add_argument("--occ_stride", type=int, default=4)
    p.add_argument("--adaptive_budget", action="store_true", default=None)
    p.add_argument("--log2_hashmap_size", type=int, default=None)
    p.add_argument("--eval_interval", type=int, default=50)
    p.add_argument("--num_views", type=int, default=0)
    p.add_argument("--views_per_time", type=int, default=0)
    p.add_argument("--gui", action="store_true")
    p.add_argument("--W", type=int, default=800)
    p.add_argument("--H", type=int, default=800)
    p.add_argument("--radius", type=float, default=3.0)
    p.add_argument("--fovy", type=float, default=60.0)
    p.add_argument("--save_mesh", action="store_true")
    p.add_argument("--mesh_resolution", type=int, default=256)
    return p


def refuse_unported(args):
    """Raise NotImplementedError, naming the ROADMAP.md item, for the one
    CLI option whose code is not ported yet (--gui), in every CLI of the
    port alike; raise RuntimeError where the run asks for the card (the
    default) and there is none."""
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device (pass --device cpu to run the "
                           "plain PyTorch versions on the CPU)")
    if getattr(args, "gui", False):
        raise NotImplementedError(
            "--gui: not ported yet (ROADMAP.md Queue 1, item 8 'GUI state "
            "and scripts', the last part of the former 'Other backends and "
            "families')")


def build_options(args) -> RenderOptions:
    coarse = getattr(args, "coarse_steps", 64)
    num_candidates = getattr(args, "num_candidates", None)
    if num_candidates is None:
        if coarse > 0 and args.dt_gamma == 0:
            num_candidates = min(args.max_steps, 256)
        else:
            num_candidates = args.max_steps
    return RenderOptions(
        bound=args.bound, dt_gamma=args.dt_gamma, max_steps=args.max_steps,
        budget_per_ray=args.budget_per_ray, num_candidates=num_candidates,
        num_steps=args.num_steps, upsample_steps=args.upsample_steps,
        min_near=args.min_near, bg_radius=args.bg_radius,
        coarse_steps=coarse, occ_stride=getattr(args, "occ_stride", 4))


def build_train_config(args, family: str = "ngp") -> TrainConfig:
    adaptive = getattr(args, "adaptive_budget", None)
    if adaptive is None:
        adaptive = bool(getattr(args, "O", False))
    eval_kw = {}
    if getattr(args, "O", False):
        # -O eval point: budget 48, two-level march, flat_frac 0.5 cap with
        # demand-adaptive per-chunk buckets, 2^15-ray chunks
        eval_kw = dict(eval_chunk=2**15, eval_budget_per_ray=48,
                       eval_flat_frac=0.5)
        if family == "tensorf":
            # a TensoRF field holds [rank, M] plane and line samples per
            # query: 4096-ray chunks keep them bounded
            eval_kw["eval_chunk"] = 4096
    return TrainConfig(
        lr=args.lr, max_steps=args.iters, num_rays=args.num_rays,
        density_thresh=args.density_thresh,
        error_map=args.error_map, color_space=args.color_space,
        adaptive_budget=adaptive, workspace=args.workspace, **eval_kw)


def load_dataset(args, split: str = "trainval", device=None):
    from seal3d_tpu_torch.data.provider import NeRFDataset
    from seal3d_tpu_torch.data.synthetic import (DynamicSyntheticScene,
                                                 SyntheticScene)

    if args.path.startswith("synthetic"):
        dynamic = "dynamic" in args.path
        scene = DynamicSyntheticScene() if dynamic else SyntheticScene()
        n = {"trainval": 24, "train": 20, "val": 4, "test": 8}.get(split, 8)
        if split in ("trainval", "train") and getattr(args, "num_views", 0):
            n = args.num_views
        seed = {"trainval": 0, "train": 0, "val": 1, "test": 2}.get(split, 2)
        kw = {}
        vpt = getattr(args, "views_per_time", 0)
        if vpt and dynamic:
            kw["views_per_time"] = vpt
        return scene.make_dataset(
            n_views=n, h=args.H // args.downscale, w=args.W // args.downscale,
            seed=seed, device=device, **kw)
    return NeRFDataset.load(args.path, split=split, downscale=args.downscale,
                            scale=args.scale, offset=tuple(args.offset),
                            use_error_map=args.error_map)


def grid_defaults(args):
    """(backend, log2_hashmap_size, gridtype): -O selects the halo backend
    over the 'wrap' gridtype at T=2^15; plain mode keeps reference hashing
    at T=2^19. The reference's VMEM ceiling (2^18) is a TPU limit; K1
    gathers from the master table at any cubic size."""
    backend = args.grid_backend or ("halo" if args.O else "xla")
    log2 = args.log2_hashmap_size or (
        15 if backend in ("pallas", "halo") else 19)
    gridtype = "wrap" if backend == "halo" else "hash"
    if backend == "halo" and log2 % 3 != 0:
        raise SystemExit(
            f"--grid_backend halo needs a cubic table (T = P^3, i.e. "
            f"log2_hashmap_size divisible by 3; got {log2})")
    return backend, log2, gridtype
