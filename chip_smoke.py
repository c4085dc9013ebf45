#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seal3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--workspace DIR]

Phases, each of which raises (exit code != 0) when it fails:
1. print the card (nvidia-smi name and power limit) and build the CUDA
   kernels from csrc/ with nvcc;
2. K1 (halo_encode_fwd) against its plain PyTorch version at the -O widths
   (L=16, T=2^15, F=4 and F=2), 2^20 random points with 25% invalid:
   max abs diff <= 1e-5 (both fp32; only the summation order differs), and
   both times from CUDA events;
3. the main path at full -O width, bound 1: the port Trainer on the
   synthetic test split (8 views, 800x800) runs init_state (mark_untrained)
   and one full grid update through the NGP density (K1, F=2); the analytic
   scene's occupancy is installed (a random-init field would fill the grid
   with fog), a checkpoint is saved, and the port's CLI
   (`seal3d_tpu_torch.main_nerf --test`) loads it and renders all 8 views.
   K1's launch count over this phase must be > 0 and equal the field calls;
4. K1 against the plain version on the packed samples of a real 800x800
   render chunk (<= 1e-5), timed at that shape;
5. the card's render of a 64x64 view against the same render on the CPU
   through the plain version (a reference on a small input);
6. K1's backward (halo_encode_bwd) against its plain PyTorch version at the
   -O widths (L=16, T=2^15, F=4 and F=2): M=196,608 (one [N, K] train
   step, 4096 rays x 48) all valid, and M=2^20 with 25% invalid rows. The
   table gradient within BWD_RTOL of its largest entry, invalid rows adding
   nothing; both times from CUDA events;
7. the train path at full -O width through the port's CLI (`python -m
   seal3d_tpu_torch.main_nerf synthetic -O --bound 1.0 --dt_gamma 0
   --min_near 0.05 --max_steps 512 --iters 576 --H 256 --W 256`): the loss
   falls, the step-576 checkpoint holds the optimizer state, K1's backward
   ran once per train step and its forward once per field call, and the val
   PSNR is >= 25 dB. Prints ms per step and train rays/s over the steps
   after the first 48, the seconds of the full and partial grid updates, and
   a torch.profiler breakdown of three more train steps.
8. the hash-encode kernels (hash_encode_fwd, hash_encode_bwd: K3, and K2 as
   the backward's scatter) against their plain PyTorch versions at full NGP
   width (L=16) in both level layouts, 'bucket' at T=2^19 (native levels)
   and 'pallas' at T=2^15 (levels padded to T): the forward at M=2^20 random
   points, F=4 and F=2, max abs diff <= 1e-5; the backward at M=196,608 and
   M=2^20, F=4 and F=2, within BWD_RTOL of its largest entry; both times
   from CUDA events. Also times the per-call stacking copy of the two
   tables and the backward over the dense coarse levels alone;
9. the bucket train path through the CLI (phase 7's command with
   `--grid_backend bucket`: T=2^19, 16 levels, F=2 per grid): phase 7's
   checks with the hash-encode launch counts (K1 launches 0), then the
   trained params through `export_torch_ngp` / `import_torch_ngp` into a
   fresh params tree: every leaf bit-identical;
10. the pallas train path (`--grid_backend pallas`: T=2^15, levels padded):
   the same checks, the `.pth` round trip going through
   `convert_table_layout` (padding rows come back zero): the imported
   tables encode 2^20 random points bit-identically to the trained ones,
   and the MLP leaves are bit-identical.
11. K4 (ladder_plan) against its plain PyTorch version at the -O eval point
   (bound 1, max_steps 512, 256 candidates in groups of 4, 32 coarse steps,
   pool 64) on the busiest chunk of a real 800x800 test view, bitfield and
   occupancy AABB from phase 7's trained state: t0 and far within 1e-6, the
   kept groups' mismatch share <= 1e-3 (0 expected), the demand within 1e-3
   relative and >= the samples the fine repack keeps. Both times from CUDA
   events, and the kernel launches the plain version takes (profiler);
12. the 8 test views at 800x800 from phase 7's state through
   `Trainer.render_image` with `RenderOptions(tl_kernel=True)` and `False`:
   images within 1e-5, depths within 1e-4, equal sample counts; K4 launched
   once per demand probe and once per rendered chunk; seconds and kernel
   launches per view both ways;
13. K5 (multilevel_lookup forward and backward) through `hashgrid_encode`
   with backend 'pallas' where the fused encode does not apply: (a) L=16,
   T=2^15, 3-D, align_corners, F=4 and F=2, M=2^18; (b) the geometry of
   NGP's background grid (L=4, T=2^19, F=2, 2-D), M=2^20. Against the plain
   gather and its autograd gradient (forward <= 1e-5, backward within
   BWD_RTOL of the largest entry); then the kernels alone on the same
   indices against their plain versions and against the bare
   `index_select` / `index_add_` calls, all timed;
14. the bbox edit through the port's CLI at full -O width, 256x256 views
   (`python -m seal3d_tpu_torch.main_SealNeRF synthetic -O --bound 1.0
   --dt_gamma 0 --min_near 0.05 --max_steps 512 --H 256 --W 256
   --seal_config seal_config_bbox --teacher_ckpt <phase 7's step-576 .npz>
   --pretraining_epochs 50 --extra_epochs 500`): the pretrain loss falls;
   timer.json, seal.json and options.json exist; the proxied dataset has
   depths; K1's forward ran once per field call and its backward once per
   pretrain batch and finetune step; all test views are finite; on 4 val
   poses the student against the mapped teacher reads >= 25 dB, and on the
   pixels the edit changes the unedited teacher reads lower than the
   student against the same target (the edit took); after
   restore_grid the bitfield no longer holds the force-fill; the edited
   test views through K4 equal those without. Prints pretrain s per epoch,
   proxy s, finetune ms per step and each stage's share of the wall.
The line before the last is the kernel table as JSON (seven kernels, each
with its launches on the main paths, its error, its time, the plain
version's, the bound from this run's shapes and, where one PyTorch call
computes the same function, that call's time); the last line is
{"ok": true, "device": {...}}. There is no CPU path: without a CUDA device
the script exits non-zero before printing any result.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 1e-5  # K1 vs plain: fp32 both, summation order only
# K1 backward vs plain, relative to the largest gradient entry: fp32 atomics
# (and the plain index_add_, itself an atomic scatter on the card) sum up to
# a few thousand terms per row in an order that changes from run to run
BWD_RTOL = 1e-5
TRAIN_STEPS = 576
MIN_VAL_PSNR = 25.0  # a field with broken gradients stays near 12-15 dB
MIN_EDIT_PSNR = 25.0  # the student against the mapped teacher, 4 val poses
SEAL_EPOCHS, SEAL_STEPS = 50, 500   # the recipe's pretrain epochs, finetune
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
# fp32 operations/s outside the tensor cores; the bound of a kernel is the
# larger of its bytes over the first and its operations over the second
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 10) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(kernel, plain):
    """(kernel ms, plain ms) of two no-argument callables, timed in turns
    plain, kernel, kernel, plain so clock drift hits both alike."""
    with torch.no_grad():
        p1 = time_ms(plain, 3)
        k1 = time_ms(kernel)
        k2 = time_ms(kernel)
        p2 = time_ms(plain, 3)
    return (k1 + k2) / 2, (p1 + p2) / 2


def compare(kernel, plain):
    """(max abs diff, max |plain|, kernel ms, plain ms) of two no-argument
    callables that return one tensor."""
    with torch.no_grad():
        ref = plain()
        err = float((kernel() - ref).abs().max())
        scale = float(ref.abs().max())
        del ref
    return (err, scale, *time_turns(kernel, plain))


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take for n_bytes moved (each input
    read once, each output written once) and n_ops fp32 operations."""
    by = n_bytes / PEAK_BYTES_S * 1e3
    op = n_ops / PEAK_FP32_S * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations"}


def encode_bound(m, n_valid, levels, f, table_rows, valid_bytes=0,
                 hashed_levels=0) -> dict:
    """Bound of a multiresolution encode, forward or backward alike: per row
    x (12 B) and its valid byte, the [M, L*F] fp32 features (forward: out;
    backward: the cotangent in) once, the [rows, F] fp32 table once (read,
    or written as the gradient). Per valid (row, level): 8 corners x F
    multiply-adds, ~30 operations of cell and weight arithmetic, and 5 per
    corner more where the level is hashed."""
    n_bytes = m * (12 + valid_bytes) + 4 * f * (table_rows + m * levels)
    n_ops = n_valid * (levels * (16 * f + 30) + hashed_levels * 40)
    return bound(n_bytes, n_ops)


def count_launches(fn) -> int:
    """Kernel launches of one call of fn (after one warm-up call), from
    torch.profiler's CUDA-runtime events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_KEYS)


def psnr(a, b) -> float:
    return float(-10.0 * torch.log10(((a - b) ** 2).mean()))


def kernel_vs_plain(table, x, valid, cfg):
    """K1 forward: (max abs diff, kernel ms, plain ms)."""
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_plain

    err, _, ms, plain_ms = compare(
        lambda: halo_encode(table, x, valid, cfg),
        lambda: halo_encode_plain(table, x, valid, cfg))
    return err, ms, plain_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workspace", default=None,
                    help="keep checkpoint and renders here (default: a "
                         "temporary directory, removed at exit)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script has no CPU "
                         "path)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from seal3d_tpu_torch.runtime.build import build_library, load_library

    t0 = time.perf_counter()
    built = build_library()
    load_library()
    print(f"[build] kernel library {os.path.basename(built.path)}: "
          f"{time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        ws = args.workspace or tmp
        k1_fwd, ds800 = run_phases(dev, ws)
        k1_bwd = k1_bwd_phase(dev)
        tr7, fwd_launches, bwd_launches = train_phase(os.path.join(ws, "train"))
        k1_fwd["launches"] += fwd_launches
        k1_bwd["launches"] += bwd_launches
        hash_rows = hash_kernels_phase(dev)
        for backend in ("bucket", "pallas"):
            tr, fwd, bwd = train_phase(os.path.join(ws, f"train_{backend}"),
                                       backend)
            pth_round_trip(tr, os.path.join(ws, f"train_{backend}"))
            hash_rows[0]["launches"] += fwd
            hash_rows[1]["launches"] += bwd
            del tr
        k4 = ladder_phase(dev, tr7, ds800, ws)
        del ds800
        k5_rows = lookup_phase(dev)
        teacher_ckpt = os.path.join(ws, "train", "checkpoints",
                                    f"ngp_step{TRAIN_STEPS:07d}.npz")
        fwd, bwd, k4_seal = seal_phase(dev, os.path.join(ws, "seal"),
                                       teacher_ckpt)
        k1_fwd["launches"] += fwd
        k1_bwd["launches"] += bwd
        k4["launches"] += k4_seal
    kernels = [k1_fwd, k1_bwd, *hash_rows, k4, *k5_rows]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for row in kernels:
        check(set(row) == keys, f"kernel row {row.get('name')}: keys "
                                f"{sorted(set(row) ^ keys)} missing or extra")
        check(row["launches"] > 0, f"{row['name']} was launched no time on "
                                   f"the main paths")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def run_phases(dev, ws):
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser, grid_defaults,
                                         load_dataset)
    from seal3d_tpu_torch.data.rays import get_full_rays
    from seal3d_tpu_torch.data.synthetic import SyntheticScene
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.models.ngp import NGPConfig
    from seal3d_tpu_torch.ops.halo_encode import halo_encode
    from seal3d_tpu_torch.ops.hashgrid import HashGridConfig
    from seal3d_tpu_torch.render.occupancy import (occupancy_init,
                                                   occupancy_update)
    from seal3d_tpu_torch.render.renderer import march_flat
    from seal3d_tpu_torch.train.checkpoint import map_tree
    from seal3d_tpu_torch.train.trainer import Trainer

    # --- phase 2: K1 vs plain on random points at the -O widths
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15,
                         desired_resolution=2048, gridtype="wrap",
                         backend="halo")
    rng = np.random.default_rng(0)
    m = 2**20
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=m) >= 0.25).to(dev)
    max_err = 0.0
    for f in (4, 2):
        tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                               .astype(np.float32)).to(dev)
        err, ms, plain_ms = kernel_vs_plain(tab, x, valid, cfg)
        print(f"[k1 random] M=2^20 L=16 T=2^15 F={f}: max_abs_err {err:.3e} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        check(err <= TOL, f"K1 F={f} disagrees with plain: {err}")
        max_err = max(max_err, err)
    del x, valid, tab

    # --- phase 3: the main path at full -O width
    ckpt = os.path.join(ws, "checkpoints", "ngp_step0000000.npz")
    argv = ["synthetic", "-O", "--test", "--bound", "1.0", "--dt_gamma", "0",
            "--min_near", "0.05", "--max_steps", "512", "--device", "cuda",
            "--workspace", ws, "--ckpt", ckpt]
    cli = common_parser("chip_smoke").parse_args(argv)
    backend, log2t, gridtype = grid_defaults(cli)
    fcfg = NGPConfig(bound=cli.bound, log2_hashmap_size=log2t,
                     grid_backend=backend, gridtype=gridtype)
    check(backend == "halo", f"-O should select the halo backend: {backend}")

    halo_encode.launches = 0
    t0 = time.perf_counter()
    ds = load_dataset(cli, "test", device=dev)
    torch.cuda.synchronize()
    print(f"[main] synthetic test split {len(ds)} x {ds.h}x{ds.w}: "
          f"{time.perf_counter() - t0:.2f} s")
    tr = Trainer(ngp, fcfg, build_options(cli), build_train_config(cli),
                 dataset=ds, seed=0, device=dev)
    t0 = time.perf_counter()
    tr.init_state()
    torch.cuda.synchronize()
    untrained = int((tr.state.occ.density_grid < 0).sum())
    print(f"[main] init_state (mark_untrained: {untrained} cells untrained): "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    tr.update_grid()
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    grid_launches = halo_encode.launches
    print(f"[main] full grid update (2^21 cells, 2^17 chunks): {grid_s:.3f} s, "
          f"K1 launches {grid_launches}, mean_density "
          f"{float(tr.state.occ.mean_density):.4f}")
    check(grid_launches == 16, f"grid update made {grid_launches} K1 calls")

    occ = occupancy_update(occupancy_init(1, device=dev),
                           SyntheticScene().density, bound=1.0,
                           density_thresh=0.01,
                           generator=torch.Generator(device=dev).manual_seed(2))
    tr.state = tr.state._replace(occ=occ)
    tr.save_checkpoint(ckpt)
    n_occ = int(np.unpackbits(occ.bitfield.cpu().numpy()).sum())
    print(f"[main] analytic occupancy installed ({n_occ} occupied cells), "
          f"checkpoint {os.path.basename(ckpt)}")

    t0 = time.perf_counter()
    tr2 = main_nerf.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = halo_encode.launches
    stats = tr2.render_stats
    check(len(stats) == 8, f"{len(stats)} views rendered, expected 8")
    for i, s in enumerate(stats):
        print(f"[main] view {i}: {s['seconds']:.3f} s, chunks rendered "
              f"{s['chunks_rendered']} skipped {s['chunks_skipped']}, "
              f"buckets {s['buckets']}, samples {s['samples']}")
        check(s["chunks_rendered"] >= 1, f"view {i} rendered no chunk")
        check(s["nonfinite"] == 0, f"view {i} has non-finite pixels")
    field_calls = grid_launches + sum(s["chunks_rendered"] for s in stats)
    print(f"[main] main_nerf --test: {cli_s:.2f} s for 8 views; "
          f"K1 launches {launches} (field calls {field_calls})")
    check(launches > 0 and launches == field_calls,
          f"K1 launches {launches} != field calls {field_calls}")
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    check(len(pngs) == 8, f"{len(pngs)} PNGs written")

    # --- phase 4: K1 vs plain on the packed samples of a real chunk
    st = tr2.state
    rays = get_full_rays(torch.as_tensor(ds.poses[0], device=dev),
                         tr2._intrinsics, ds.h, ds.w)
    sel, _, _ = tr2._chunk_layout(ds.h, ds.w, tr2.cfg.eval_chunk)
    full = [s for s in sel if (s >= 0).all()]  # chunks without pad slots
    demand = [int(tr2._eval_demand(st.occ.bitfield, rays["rays_o"][s],
                                   rays["rays_d"][s], st.occ.occ_aabb,
                                   len(s))[0]) for s in full]
    idx = torch.as_tensor(full[int(np.argmax(demand))], device=dev)
    opts = dataclasses.replace(tr2.eval_opts, flat_frac=tr2.cfg.eval_flat_frac)
    mf = march_flat(rays["rays_o"][idx], rays["rays_d"][idx], st.occ.bitfield,
                    opts, tr2._march_aabb(st.occ.occ_aabb))
    xn = ((mf.xyzs + fcfg.bound) / (2.0 * fcfg.bound)).contiguous()
    table = torch.cat([st.ema_params["encoder"], st.ema_params["encoder_color"]],
                      dim=-1)
    err, ms, plain_ms = kernel_vs_plain(table, xn, mf.valid, fcfg.grid)
    print(f"[k1 chunk] view 0, busiest chunk: M={xn.shape[0]} "
          f"({int(mf.valid.sum())} valid) F=4: max_abs_err {err:.3e} "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    check(err <= TOL, f"K1 disagrees with plain on a real chunk: {err}")
    max_err = max(max_err, err)

    # --- phase 5: card vs CPU (plain version) on a small view
    small = SyntheticScene().make_dataset(n_views=1, h=64, w=64, seed=2,
                                          device=dev)
    imgs = []
    for device in (dev, torch.device("cpu")):
        t = Trainer(ngp, fcfg, tr2.opts, tr2.cfg, dataset=small, device=device)
        t.state = map_tree(st, lambda _, v: v.to(device))
        imgs.append(t.render_image(small.poses[0], 64, 64))
        check(t.render_stats[-1]["chunks_rendered"] == 1,
              "the 64x64 reference view rendered nothing")
    d_img = float((imgs[0][0].cpu() - imgs[1][0]).abs().max())
    d_dep = float((imgs[0][1].cpu() - imgs[1][1]).abs().max())
    print(f"[ref] 64x64 view ({t.render_stats[-1]['samples']} samples), card "
          f"vs CPU plain path: image max diff {d_img:.3e}, depth max diff "
          f"{d_dep:.3e}")
    check(d_img <= 1e-3 and d_dep <= 1e-3,
          f"card render disagrees with the CPU reference: {d_img} {d_dep}")
    # the row is timed at the real chunk: its bound from that chunk's shapes
    n_valid = int(mf.valid.sum())
    return {"name": "halo_encode_fwd", "route": "cuda",
            "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
            "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:368",
            "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **encode_bound(xn.shape[0], n_valid, 16, 4, table.shape[0],
                           valid_bytes=1)}, ds


def k1_bwd_phase(dev):
    """Phase 6 -> the kernel-table row of halo_encode_bwd, timed at the
    M=196,608 F=4 case (the train step's shape); max_abs_err is that
    case's; every case is checked."""
    from seal3d_tpu_torch.ops.halo_encode import (halo_encode_bwd,
                                                  halo_encode_bwd_plain)
    from seal3d_tpu_torch.ops.hashgrid import HashGridConfig

    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15,
                         desired_resolution=2048, gridtype="wrap",
                         backend="halo")
    n = cfg.total_params
    rng = np.random.default_rng(1)
    result = None
    for m, frac_invalid in ((4096 * 48, 0.0), (2**20, 0.25)):
        x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
        valid = None
        if frac_invalid:
            valid = torch.from_numpy(rng.uniform(size=m) >= frac_invalid).to(dev)
        for f in (4, 2):
            g = torch.from_numpy(rng.uniform(-1, 1, (m, 16 * f))
                                 .astype(np.float32)).to(dev)
            err, scale, ms, plain_ms = compare(
                lambda: halo_encode_bwd(g, x, valid, cfg, n),
                lambda: halo_encode_bwd_plain(g, x, valid, cfg, n))
            msg = ""
            if valid is not None:  # invalid rows' (nonzero) g adds nothing
                alone = halo_encode_bwd(torch.where(valid[:, None], g, 0.0),
                                        x, None, cfg, n)
                ref = halo_encode_bwd_plain(g, x, valid, cfg, n)
                inv = float((alone - ref).abs().max())
                check(inv <= BWD_RTOL * scale,
                      f"K1 bwd: invalid rows changed the gradient by {inv}")
                msg = f", invalid rows add {inv:.3e}"
                del alone, ref
            print(f"[k1 bwd] M={m} L=16 T=2^15 F={f} invalid {frac_invalid}: "
                  f"max_abs_err {err:.3e} (max |grad| {scale:.3e}, "
                  f"rel {err / scale:.3e}){msg}; kernel {ms:.3f} ms plain "
                  f"{plain_ms:.3f} ms")
            check(err <= BWD_RTOL * scale,
                  f"K1 bwd M={m} F={f} disagrees with plain: {err} of {scale}")
            if result is None:
                result = {
                    "name": "halo_encode_bwd", "route": "cuda",
                    "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
                    "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:429",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": None,
                    **encode_bound(m, m, 16, f, n)}
    return result


def train_phase(ws, backend="halo"):
    """Phase 7 (halo, the -O default), 9 (bucket) or 10 (pallas) -> (the
    trainer, forward launches, backward launches) of the backend's kernels
    over the CLI training run."""
    from seal3d_tpu_torch import main_nerf
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_bwd
    from seal3d_tpu_torch.ops.hash_encode import hash_encode, hash_encode_bwd

    families = {"K1": (halo_encode, halo_encode_bwd),
                "hash-encode": (hash_encode, hash_encode_bwd)}
    own = "K1" if backend == "halo" else "hash-encode"
    tag = "[train]" if backend == "halo" else f"[train {backend}]"
    argv = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0",
            "--min_near", "0.05", "--max_steps", "512", "--iters",
            str(TRAIN_STEPS), "--H", "256", "--W", "256", "--device", "cuda",
            "--workspace", ws]
    if backend != "halo":
        argv += ["--grid_backend", backend]
    for fns in families.values():
        for fn in fns:
            fn.launches = 0
    t0 = time.perf_counter()
    tr = main_nerf.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    fwd, bwd = (fn.launches for fn in families[own])
    others = {name: [fn.launches for fn in fns]
              for name, fns in families.items() if name != own}
    check(tr.fcfg.grid_backend == backend,
          f"the CLI picked {tr.fcfg.grid_backend}, expected {backend}")

    st = tr.train_stats
    grid = st["grid_updates"]
    full = [s for f, s in grid if f]
    part = [s for f, s in grid if not f]
    step_ms = st["window_s"] / st["window_steps"] * 1e3
    rays_s = tr.cfg.num_rays * st["window_steps"] / st["window_s"]
    g = tr.fcfg.grid
    print(f"{tag} main_nerf {TRAIN_STEPS} steps at 256x256, grid "
          f"{g.backend}/{g.gridtype} T=2^{g.log2_hashmap_size} "
          f"({g.total_params} rows): {cli_s:.2f} s in all (data, training, "
          f"eval, 8 test renders)")
    print(f"{tag} steps {st['steps'] - st['window_steps'] + 1}-"
          f"{st['steps']}: {step_ms:.3f} ms per step, {rays_s:.0f} train "
          f"rays/s (grid updates included); full grid update "
          f"{np.mean(full):.4f} s (x{len(full)}), partial "
          f"{np.mean(part):.4f} s (x{len(part)}); final flat_frac "
          f"{tr.opts.flat_frac}")
    losses = [h["loss"] for h in tr.history]
    print(f"{tag} logged losses {[round(v, 5) for v in losses]} at steps "
          f"{[h['step'] for h in tr.history]}")
    check(len(losses) >= 2 and losses[-1] < losses[0],
          f"{backend}: the loss did not fall: {losses}")
    ckpt = os.path.join(ws, "checkpoints", f"ngp_step{TRAIN_STEPS:07d}.npz")
    with np.load(ckpt) as data:
        keys = [k for k in data.files if k.startswith("opt_state/")]
        counts = [int(data["opt_state/0/count"]), int(data["opt_state/1/count"])]
    print(f"{tag} {os.path.basename(ckpt)}: {len(keys)} opt_state arrays, "
          f"counts {counts}")
    check(counts == [TRAIN_STEPS] * 2 and len(keys) == 2 * 7 + 2,
          f"{backend}: checkpoint optimizer state: {len(keys)} keys, counts "
          f"{counts}")
    n_full, n_part = len(full), len(part)
    chunks = sum(s["chunks_rendered"] for s in tr.render_stats)
    field_calls = TRAIN_STEPS + 16 * n_full + 3 * n_part + chunks
    print(f"{tag} {own} launches: backward {bwd} (train steps "
          f"{TRAIN_STEPS}), forward {fwd} (field calls {field_calls}: "
          f"{TRAIN_STEPS} steps, {n_full}x16 + {n_part}x3 grid-update chunks, "
          f"{chunks} rendered eval/test chunks); other kernels "
          f"(forward, backward) {others}")
    check(bwd == TRAIN_STEPS, f"{own} bwd launches {bwd} != steps "
                              f"{TRAIN_STEPS}")
    check(fwd == field_calls, f"{own} fwd launches {fwd} != field calls "
                              f"{field_calls}")
    check(all(n == 0 for c in others.values() for n in c),
          f"{backend}: other kernels launched: {others}")
    psnr = tr.eval_history[-1]["psnr"]
    print(f"{tag} val PSNR {psnr:.2f} dB over 4 views at 256x256 (for "
          f"reading only, not like for like: the JAX reference reached 38.92 "
          f"dB after 576 steps on a train view in its TPU run, "
          f"BENCH_r05.json)")
    check(psnr >= MIN_VAL_PSNR, f"{backend}: val PSNR {psnr:.2f} < "
                                f"{MIN_VAL_PSNR}")
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    check(len(pngs) == 8, f"{backend}: {len(pngs)} test PNGs written")
    # the CLI writes two compressed checkpoints (the step one with the
    # optimizer state, the eval's _best without), as the reference does;
    # their cost grows with the table
    t0 = time.perf_counter()
    path = tr.save_checkpoint(os.path.join(ws, "timed.npz"))
    print(f"{tag} one full .npz checkpoint "
          f"({os.path.getsize(path) / 2**20:.1f} MiB, np.savez_compressed): "
          f"{time.perf_counter() - t0:.2f} s")
    profile_steps(tr)
    return tr, fwd, bwd


def hash_kernels_phase(dev):
    """Phase 8 -> the kernel-table rows of hash_encode_fwd (timed at the
    bucket layout, M=2^20, F=4) and hash_encode_bwd (bucket, M=196,608,
    F=4); max_abs_err is the largest over every case, each of which is
    checked."""
    from seal3d_tpu_torch.ops.hash_encode import (hash_encode,
                                                  hash_encode_bwd,
                                                  hash_encode_bwd_plain,
                                                  hash_encode_plain)
    from seal3d_tpu_torch.ops.hashgrid import HashGridConfig

    rng = np.random.default_rng(8)
    layouts = {"bucket": 19, "pallas": 15}
    fwd = {"name": "hash_encode_fwd", "route": "cuda",
           "source": "seal3d_tpu_torch/csrc/hash_encode.cu",
           "replaces": "seal3d_tpu/ops/pallas/hash_encode.py:189",
           "launches": 0, "max_abs_err": 0.0}
    bwd = {"name": "hash_encode_bwd", "route": "cuda",
           "source": "seal3d_tpu_torch/csrc/hash_encode.cu",
           "replaces": "seal3d_tpu/ops/pallas/hash_encode.py:256; "
                       "seal3d_tpu/ops/pallas/bucket_grad.py:102",
           "launches": 0, "max_abs_err": 0.0}
    m = 2**20
    x = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(dev)
    for backend, log2t in layouts.items():
        cfg = HashGridConfig(num_levels=16, log2_hashmap_size=log2t,
                             backend=backend)
        for f in (4, 2):
            tab = torch.from_numpy(rng.uniform(-1, 1, (cfg.total_params, f))
                                   .astype(np.float32)).to(dev)
            err, _, ms, plain_ms = compare(
                lambda: hash_encode(tab, x, cfg),
                lambda: hash_encode_plain(tab, x, cfg))
            print(f"[hash fwd] {backend} T=2^{log2t} ({cfg.total_params} "
                  f"rows) M=2^20 L=16 F={f}: max_abs_err {err:.3e} kernel "
                  f"{ms:.3f} ms plain {plain_ms:.3f} ms")
            check(err <= TOL, f"hash fwd {backend} F={f} disagrees with "
                              f"plain: {err}")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
            if backend == "bucket" and f == 4:
                hashed = sum(h for *_, h, _ in cfg.level_params)
                fwd.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                           **encode_bound(m, m, 16, f, cfg.total_params,
                                          hashed_levels=hashed))
            del tab
    for backend, log2t in layouts.items():
        cfg = HashGridConfig(num_levels=16, log2_hashmap_size=log2t,
                             backend=backend)
        n = cfg.total_params
        for mb in (4096 * 48, 2**20):
            xb = x[:mb]
            for f in (4, 2):
                g = torch.from_numpy(rng.uniform(-1, 1, (mb, 16 * f))
                                     .astype(np.float32)).to(dev)
                err, scale, ms, plain_ms = compare(
                    lambda: hash_encode_bwd(g, xb, cfg, n),
                    lambda: hash_encode_bwd_plain(g, xb, cfg, n))
                hashed = sum(h for *_, h, _ in cfg.level_params)
                bnd = encode_bound(mb, mb, 16, f, n, hashed_levels=hashed)
                print(f"[hash bwd] {backend} T=2^{log2t} M={mb} L=16 F={f}: "
                      f"max_abs_err {err:.3e} (max |grad| {scale:.3e}, rel "
                      f"{err / scale:.3e}); kernel {ms:.3f} ms plain "
                      f"{plain_ms:.3f} ms bound {bnd['bound_ms']:.4f} ms")
                check(err <= BWD_RTOL * scale,
                      f"hash bwd {backend} M={mb} F={f} disagrees with "
                      f"plain: {err} of {scale}")
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
                if backend == "bucket" and mb == 4096 * 48 and f == 4:
                    bwd.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                               **bnd)
    # what the bucket field pays around the kernels: the per-call stacking
    # of the sigma and color tables into one F=4 table (as the reference),
    # and the backward over the dense coarse levels alone (levels 0-4: their
    # atomics contend, thousands of samples per entry), per (sample, level)
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=19,
                         backend="bucket")
    t2 = [torch.zeros((cfg.total_params, 2), device=dev) for _ in range(2)]
    cat_ms = time_ms(lambda: torch.cat(t2, dim=-1))
    dense = sum(not h for *_, h, _ in cfg.level_params)
    coarse = HashGridConfig(
        num_levels=dense, log2_hashmap_size=19, backend="bucket",
        desired_resolution=16 * cfg.per_level_scale ** (dense - 1))
    check(all(not h for *_, h, _ in coarse.level_params),
          "the coarse config has a hashed level")
    mb = 4096 * 48
    xb = x[:mb]
    g = torch.from_numpy(rng.uniform(-1, 1, (mb, 16 * 4))
                         .astype(np.float32)).to(dev)
    all_ms = time_ms(lambda: hash_encode_bwd(g, xb, cfg, cfg.total_params))
    gc = g.reshape(mb, 16, 4)[:, :dense].contiguous()
    coarse_ms = time_ms(lambda: hash_encode_bwd(gc, xb, coarse,
                                                coarse.total_params))
    # K2's own function (a scatter-add of per-corner rows into the table)
    # as one PyTorch call, index_add_, on this backward's corner keys: the
    # kernel above also forms the rows (weights x cotangent) on the way
    from seal3d_tpu_torch.ops.hashgrid import corner_indices_weights

    with torch.no_grad():
        keys, w = corner_indices_weights(xb, cfg)          # [M, L, 8]
        rows = (g.reshape(mb, 16, 1, 4) * w[..., None]).reshape(-1, 4)
        keys = keys.reshape(-1)
        del w
        lib_ms = time_ms(lambda: torch.zeros(
            (cfg.total_params, 4), device=dev).index_add_(0, keys, rows), 5)
    print(f"[hash bwd] the scatter alone as index_add_ ({keys.shape[0]} rows "
          f"of F=4 into {cfg.total_params}): {lib_ms:.3f} ms")
    del keys, rows
    print(f"[hash] stacking the two T=2^19 tables (torch.cat, "
          f"{4 * 4 * cfg.total_params / 2**20:.1f} MiB out): {cat_ms:.3f} ms "
          f"per field call")
    print(f"[hash bwd] contention, bucket T=2^19 M={mb} F=4 uniform points: "
          f"all 16 levels {all_ms:.3f} ms ({all_ms / 16 * 1e3:.1f} us per "
          f"level), the {dense} dense levels alone {coarse_ms:.3f} ms "
          f"({coarse_ms / dense * 1e3:.1f} us per level)")
    return [fwd, bwd]


O_ARGV = ["synthetic", "-O", "--bound", "1.0", "--dt_gamma", "0",
          "--min_near", "0.05", "--max_steps", "512", "--device", "cuda"]


def ladder_phase(dev, tr7, ds, ws):
    """Phases 11 and 12 -> the kernel-table row of ladder_plan (K4). tr7:
    phase 7's trainer (its state is the trained teacher); ds: the 800x800
    test split."""
    from seal3d_tpu_torch.config import (build_options, build_train_config,
                                         common_parser)
    from seal3d_tpu_torch.data.rays import get_full_rays
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops.ladder import (ladder_plan, ladder_plan_plain,
                                             pack_tables)
    from seal3d_tpu_torch.render.renderer import march_flat
    from seal3d_tpu_torch.train.trainer import Trainer

    cli = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--workspace", os.path.join(ws, "ladder")])
    trainers = {}
    for on in (False, True):
        t = Trainer(ngp, tr7.fcfg,
                    dataclasses.replace(build_options(cli), tl_kernel=on),
                    build_train_config(cli), dataset=ds, device=dev)
        t.state = tr7.state
        trainers[on] = t
    t_on = trainers[True]
    eo, chunk, st = t_on.eval_opts, t_on.cfg.eval_chunk, tr7.state
    check(eo.tl_kernel_ok(t_on.cfg.eval_budget_per_ray, None)
          and not trainers[False].eval_opts.tl_kernel_ok(
              t_on.cfg.eval_budget_per_ray, None),
          "the -O eval options do not take the ladder kernel")

    # --- phase 11: K4 vs plain on the busiest chunk of test view 0
    kw = dict(bound=eo.bound, min_near=eo.min_near, max_steps=eo.max_steps,
              num_candidates=eo.num_candidates, group=eo.tl_group,
              n_coarse=eo.coarse_steps, pool=eo.tl_pool)
    cg = eo.num_candidates // eo.tl_group
    rays = get_full_rays(torch.as_tensor(ds.poses[0], device=dev),
                         t_on._intrinsics, ds.h, ds.w)
    sel, _, _ = t_on._chunk_layout(ds.h, ds.w, chunk)
    tables = pack_tables(st.occ.bitfield, eo.tl_pool)
    aabb = t_on._march_aabb(st.occ.occ_aabb).to(torch.float32).contiguous()
    full = [torch.as_tensor(s_, device=dev) for s_ in sel if (s_ >= 0).all()]
    demand = [float(ladder_plan(rays["rays_o"][i], rays["rays_d"][i], *tables,
                                aabb, **kw)[3].sum()) for i in full]
    idx = full[int(np.argmax(demand))]
    ro, rd = rays["rays_o"][idx].contiguous(), rays["rays_d"][idx].contiguous()
    t0, far, keep, cnt = ladder_plan(ro, rd, *tables, aabb, **kw)
    p0, pfar, pkeep, pcnt = ladder_plan_plain(ro, rd, *tables, aabb, **kw)
    check(keep.dtype == torch.bool and keep.shape == (chunk, cg),
          f"K4 keep is {keep.dtype} {tuple(keep.shape)}")
    err_t = max(float((t0 - p0).abs().max()), float((far - pfar).abs().max()))
    mismatch = float((keep != pkeep).float().mean())
    fine, pfine = float(cnt.sum()), float(pcnt.sum())
    err_c = abs(fine - pfine) / pfine
    hit = int((t0 < 1e9).sum())
    bucket = t_on._pick_bucket(chunk, int(fine), int(keep.sum()))
    mf = march_flat(ro, rd, st.occ.bitfield,
                    dataclasses.replace(eo, flat_frac=bucket), aabb, None,
                    tables)
    kept = int(mf.valid.sum())
    ms, plain_ms = time_turns(
        lambda: ladder_plan(ro, rd, *tables, aabb, **kw),
        lambda: ladder_plan_plain(ro, rd, *tables, aabb, **kw))
    plain_launches = count_launches(
        lambda: ladder_plan_plain(ro, rd, *tables, aabb, **kw))
    print(f"[k4] view 0, busiest chunk: N={chunk} rays ({hit} hit the box) "
          f"CG={cg} g={eo.tl_group} n_coarse={eo.coarse_steps} pool="
          f"{eo.tl_pool}: t0/far max_abs_err {err_t:.3e}, keep mismatch share "
          f"{mismatch:.3e} ({int(keep.sum())} kept groups), demand "
          f"{fine:.0f} vs plain {pfine:.0f} (rel {err_c:.3e}), fine repack "
          f"keeps {kept} at bucket {bucket}")
    print(f"[k4] kernel {ms:.4f} ms (1 launch) plain {plain_ms:.3f} ms "
          f"({plain_launches} launches)")
    check(err_t <= 1e-6, f"K4 t0/far disagree with plain: {err_t}")
    check(mismatch <= 1e-3, f"K4 keep mismatch share {mismatch}")
    check(err_c <= 1e-3, f"K4 demand {fine} vs plain {pfine}")
    check(fine >= kept > 0, f"K4 demand {fine} < fine repack's {kept}")
    # per hit ray ~30 operations per coarse step and ~25 per group, ~20 more
    # per kept group (the 128^3 test); rays that miss the box need none
    row = {"name": "ladder_plan", "route": "cuda",
           "source": "seal3d_tpu_torch/csrc/ladder.cu",
           "replaces": "seal3d_tpu/ops/pallas/ladder.py:230",
           "launches": 0, "max_abs_err": err_t, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None,
           **bound(chunk * (24 + 12 + cg) + 24
                   + sum(t.numel() for t in tables),
                   hit * (eo.coarse_steps * 30 + cg * 25)
                   + int(keep.sum()) * 20)}
    del rays, mf

    # --- phase 12: the 8 test views with and without K4
    for on in (False, True):    # one warm-up view each way
        trainers[on].render_image(ds.poses[0], ds.h, ds.w)
        trainers[on].render_stats.clear()
    ladder_plan.launches = 0
    d_img = d_dep = 0.0
    for vi in range(len(ds)):
        off = trainers[False].render_image(ds.poses[vi], ds.h, ds.w)
        on = trainers[True].render_image(ds.poses[vi], ds.h, ds.w)
        d_img = max(d_img, float((on[0] - off[0]).abs().max()))
        d_dep = max(d_dep, float((on[1] - off[1]).abs().max()))
    launches = ladder_plan.launches
    s_off = list(trainers[False].render_stats)
    s_on = list(trainers[True].render_stats)
    probes = len(sel) * len(ds)
    rendered = sum(s_["chunks_rendered"] for s_ in s_on)
    sec = {on: float(np.mean([s_["seconds"] for s_ in stats]))
           for on, stats in ((False, s_off), (True, s_on))}
    per_view = {on: count_launches(
        lambda: trainers[on].render_image(ds.poses[0], ds.h, ds.w))
        for on in (False, True)}
    print(f"[k4 render] {len(ds)} views {ds.h}x{ds.w}, tl_kernel on vs off: "
          f"image max diff "
          f"{d_img:.3e}, depth max diff {d_dep:.3e}, samples "
          f"{[s_['samples'] for s_ in s_on]}; K4 launches {launches} "
          f"({probes} probes + {rendered} rendered chunks)")
    print(f"[k4 render] s per view: off {sec[False]:.4f} on {sec[True]:.4f}; "
          f"kernel launches for view 0: off {per_view[False]} on "
          f"{per_view[True]}")
    check(d_img <= 1e-5 and d_dep <= 1e-4,
          f"the tl_kernel render differs: image {d_img} depth {d_dep}")
    check([s_["samples"] for s_ in s_on] == [s_["samples"] for s_ in s_off],
          "the tl_kernel render kept other sample counts")
    check(all(s_["nonfinite"] == 0 for s_ in s_on), "non-finite pixels")
    check(launches > 0 and launches == probes + rendered,
          f"K4 launches {launches} != probes {probes} + chunks {rendered}")
    row["launches"] = launches
    return row


def lookup_phase(dev):
    """Phase 13 -> the kernel-table rows of multilevel_lookup_fwd and
    multilevel_lookup_bwd (K5), timed at case (a) F=4; max_abs_err is the
    largest over every case, each of which is checked."""
    from seal3d_tpu_torch.ops.hashgrid import (HashGridConfig, gather_encode,
                                               hashgrid_encode,
                                               lookup_indices)
    from seal3d_tpu_torch.ops.lookup import (multilevel_lookup,
                                             multilevel_lookup_bwd,
                                             multilevel_lookup_bwd_plain,
                                             multilevel_lookup_plain)

    base = {"route": "cuda", "source": "seal3d_tpu_torch/csrc/lookup.cu",
            "launches": 0, "max_abs_err": 0.0}
    fwd = {"name": "multilevel_lookup_fwd",
           "replaces": "seal3d_tpu/ops/pallas/lookup.py:104", **base}
    bwd = {"name": "multilevel_lookup_bwd",
           "replaces": "seal3d_tpu/ops/pallas/lookup.py:156", **base}
    cases = [("3-D align_corners", dict(num_levels=16, log2_hashmap_size=15,
                                        align_corners=True), 2**18, (4, 2)),
             ("2-D background grid", dict(num_levels=4, log2_hashmap_size=19,
                                          desired_resolution=2048,
                                          input_dim=2), 2**20, (2,))]
    rng = np.random.default_rng(13)
    multilevel_lookup.launches = multilevel_lookup_bwd.launches = 0
    drives = 0
    counted = [0, 0]
    for tag, kw, m, widths in cases:
        cfg = HashGridConfig(backend="pallas", **kw)
        levels, n_rows = cfg.num_levels, cfg.total_params
        x = torch.from_numpy(rng.uniform(0, 1, (m, cfg.input_dim))
                             .astype(np.float32)).to(dev)
        for f in widths:
            tab = torch.from_numpy(rng.uniform(-1, 1, (n_rows, f))
                                   .astype(np.float32)).to(dev)
            ct = torch.from_numpy(rng.uniform(-1, 1, (m, levels * f))
                                  .astype(np.float32)).to(dev)
            # the path: hashgrid_encode and its autograd backward
            before = (multilevel_lookup.launches,
                      multilevel_lookup_bwd.launches)
            t = tab.clone().requires_grad_()
            out = hashgrid_encode(t, x, cfg)
            out.backward(ct)
            counted[0] += multilevel_lookup.launches - before[0]
            counted[1] += multilevel_lookup_bwd.launches - before[1]
            drives += 1
            tp = tab.clone().requires_grad_()
            ref = gather_encode(tp, x, cfg).reshape(m, -1)
            ref.backward(ct)
            e_f = float((out.detach() - ref.detach()).abs().max())
            e_b = float((t.grad - tp.grad).abs().max())
            scale = float(tp.grad.abs().max())
            del t, tp, out, ref, ct

            # the kernels alone, on the indices the path hands them
            with torch.no_grad():
                idx, _ = lookup_indices(x, cfg)
                n = idx.shape[1]
                rows = (idx.to(torch.int64) + torch.arange(
                    levels, device=dev)[:, None] * (n_rows // levels)
                        ).reshape(-1)
                g = torch.from_numpy(rng.uniform(-1, 1, (levels, n, f))
                                     .astype(np.float32)).to(dev)
                g2 = g.reshape(-1, f)
                same = torch.equal(multilevel_lookup(tab, idx),
                                   multilevel_lookup_plain(tab, idx))
                f_ms, f_plain = time_turns(
                    lambda: multilevel_lookup(tab, idx),
                    lambda: multilevel_lookup_plain(tab, idx))
                f_lib = time_ms(lambda: tab.index_select(0, rows))
                gk = multilevel_lookup_bwd(g, idx, n_rows)
                gp = multilevel_lookup_bwd_plain(g, idx, n_rows)
                e_k = float((gk - gp).abs().max())
                k_scale = float(gp.abs().max())
                del gk, gp
                b_ms, b_plain = time_turns(
                    lambda: multilevel_lookup_bwd(g, idx, n_rows),
                    lambda: multilevel_lookup_bwd_plain(g, idx, n_rows))
                b_lib = time_ms(lambda: torch.zeros(
                    (n_rows, f), device=dev).index_add_(0, rows, g2))
            print(f"[k5] {tag} L={levels} T=2^{cfg.log2_hashmap_size} F={f} "
                  f"M={m} ({levels * n} pairs): hashgrid_encode vs plain "
                  f"gather fwd max_abs_err {e_f:.3e}, bwd max_abs_err "
                  f"{e_b:.3e} (max |grad| {scale:.3e}, rel "
                  f"{e_b / scale:.3e}); kernel alone fwd "
                  f"{'bit-identical' if same else 'DIFFERS'}, bwd rel "
                  f"{e_k / k_scale:.3e}")
            print(f"[k5]   fwd kernel {f_ms:.3f} ms plain {f_plain:.3f} ms "
                  f"index_select {f_lib:.3f} ms; bwd kernel {b_ms:.3f} ms "
                  f"plain {b_plain:.3f} ms index_add_ {b_lib:.3f} ms")
            check(e_f <= TOL, f"K5 fwd {tag} F={f} disagrees: {e_f}")
            check(same, f"K5 fwd {tag} F={f}: kernel differs from plain")
            check(e_b <= BWD_RTOL * scale,
                  f"K5 bwd {tag} F={f} disagrees: {e_b} of {scale}")
            check(e_k <= BWD_RTOL * k_scale,
                  f"K5 bwd kernel {tag} F={f} disagrees: {e_k} of {k_scale}")
            fwd["max_abs_err"] = max(fwd["max_abs_err"], e_f)
            bwd["max_abs_err"] = max(bwd["max_abs_err"], e_b, e_k)
            if "ms" not in fwd:
                # idx 4 B and one row out per pair; the rows gathered, at
                # most the whole table; no arithmetic but the row address
                pairs = levels * n
                fwd.update(ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                           **bound(pairs * (4 + 4 * f)
                                   + 4 * f * min(pairs, n_rows), pairs))
                bwd.update(ms=b_ms, plain_ms=b_plain, library_ms=b_lib,
                           **bound(pairs * (4 + 4 * f) + 4 * f * n_rows,
                                   pairs * f))
            del tab, g, g2, idx, rows
    print(f"[k5] launches through hashgrid_encode and its backward: forward "
          f"{counted[0]}, backward {counted[1]} ({drives} calls)")
    check(counted == [drives, drives],
          f"K5 launches {counted} != hashgrid_encode calls {drives}")
    fwd["launches"], bwd["launches"] = counted
    return [fwd, bwd]


def seal_phase(dev, ws, teacher_ckpt):
    """Phase 14 -> (K1 forward launches, K1 backward launches, K4 launches)
    of the bbox edit through the CLI and of the edited views' renders."""
    from seal3d_tpu_torch import main_SealNeRF
    from seal3d_tpu_torch.config import common_parser, load_dataset
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_bwd
    from seal3d_tpu_torch.ops.hash_encode import hash_encode, hash_encode_bwd
    from seal3d_tpu_torch.ops.ladder import ladder_plan
    from seal3d_tpu_torch.seal.renderer import hack_bitfield
    from seal3d_tpu_torch.train.trainer import Trainer

    epochs, steps = SEAL_EPOCHS, SEAL_STEPS
    here = os.path.dirname(os.path.abspath(__file__))
    argv = O_ARGV + ["--H", "256", "--W", "256", "--seal_config",
                     os.path.join(here, "seal_config_bbox"),
                     "--teacher_ckpt", teacher_ckpt,
                     "--pretraining_epochs", str(epochs), "--extra_epochs",
                     str(steps), "--workspace", ws]
    for fn in (halo_encode, halo_encode_bwd, hash_encode, hash_encode_bwd,
               ladder_plan):
        fn.launches = 0
    t0 = time.perf_counter()
    st = main_SealNeRF.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    fwd, bwd = halo_encode.launches, halo_encode_bwd.launches
    check(hash_encode.launches == 0 and hash_encode_bwd.launches == 0
          and ladder_plan.launches == 0, "the -O edit launched other kernels")

    for name in ("timer.json", "seal.json", "options.json"):
        check(os.path.exists(os.path.join(ws, name)), f"{name} not written")
    with open(os.path.join(ws, "timer.json")) as f:
        timer = json.load(f)
    losses = st.pretrain_losses
    print(f"[seal] main_SealNeRF bbox edit at 256x256: {cli_s:.2f} s in all; "
          f"pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f} over "
          f"{len(losses)} epochs")
    check(len(losses) == epochs and losses[-1] < losses[0]
          and np.all(np.isfinite(losses)), f"pretrain losses {losses}")
    ds = st.dataset
    check(ds.depths is not None and ds.images.dtype == np.uint8
          and float(ds.depths.max()) > 0, "the proxied dataset has no depths")

    # every field call went through K1: count them
    shells = {k: (int(v["weight"].sum()), v["n_batches"])
              for k, v in st.pretrain_data.items()}
    queries = sum(-(-n // 2**18) for n, _ in shells.values())
    batches = epochs * sum(nb for _, nb in shells.values())
    grid = st.train_stats["grid_updates"]
    n_full = sum(1 for full, _ in grid if full) + 2   # hacked start, restore
    n_part = sum(1 for full, _ in grid if not full)
    ps = st.proxy_stats
    proxy_chunks = ps["chunks_grid"] + ps["chunks_packed"]
    test_chunks = sum(s_["chunks_rendered"] for s_ in st.render_stats)
    field_calls = (queries + batches + steps + 16 * n_full + 3 * n_part
                   + proxy_chunks + test_chunks)
    print(f"[seal] shells (points, batches) {shells}; K1 launches: backward "
          f"{bwd} ({batches} pretrain batches + {steps} finetune steps), "
          f"forward {fwd} (field calls {field_calls}: {queries} teacher "
          f"queries, {batches} + {steps} steps, {n_full}x16 + {n_part}x3 "
          f"grid-update chunks, {proxy_chunks} proxy chunks of {ps}, "
          f"{test_chunks} test chunks)")
    check(bwd == batches + steps, f"K1 bwd launches {bwd} != "
                                  f"{batches + steps}")
    check(fwd == field_calls, f"K1 fwd launches {fwd} != field calls "
                              f"{field_calls}")
    check(len(st.render_stats) == 8
          and all(s_["nonfinite"] == 0 for s_ in st.render_stats),
          "edited test views: count or non-finite pixels")

    wall = (timer["pretrain_init"] + timer["pretraining_total"]
            + timer["proxy_dataset"] + timer["training_total"])
    ts = st.train_stats
    print(f"[seal] init {timer['pretrain_init']:.3f} s, pretrain "
          f"{timer['pretraining_avg']:.4f} s per epoch "
          f"({timer['pretraining_total']:.2f} s), proxy "
          f"{timer['proxy_dataset']:.3f} s for {ps['views']} views, finetune "
          f"{timer['training_total']:.2f} s "
          f"({ts['window_s'] / ts['window_steps'] * 1e3:.3f} ms per step "
          f"after the first {steps - ts['window_steps']}, grid updates "
          f"included; final flat_frac {st.opts.flat_frac}); shares of "
          f"{wall:.2f} s: init {timer['pretrain_init'] / wall:.3f} pretrain "
          f"{timer['pretraining_total'] / wall:.3f} proxy "
          f"{timer['proxy_dataset'] / wall:.3f} finetune "
          f"{timer['training_total'] / wall:.3f}")

    # the edit took: student vs mapped teacher, unedited teacher vs the same
    cli = common_parser("chip_smoke").parse_args(
        O_ARGV + ["--H", "256", "--W", "256", "--workspace", ws])
    val = load_dataset(cli, "val", device=dev)
    plain_teacher = Trainer(ngp, st.fcfg, st.opts, st.cfg, dataset=val,
                            device=dev, name="teacher_unedited")
    plain_teacher.load_checkpoint(teacher_ckpt)
    # whole images, and the pixels the edit changes: those where the mapped
    # teacher's view differs from the unedited teacher's by > 0.1
    ps_student, ps_teacher = [], []
    n_px, se_student, se_teacher = 0, 0.0, 0.0
    for pose in val.poses[:4]:
        target, _ = st.render_teacher_view(pose, val.h, val.w)
        edited = st.render_image(pose, val.h, val.w)[0]
        unedited = plain_teacher.render_image(pose, val.h, val.w)[0]
        ps_student.append(psnr(edited, target))
        ps_teacher.append(psnr(unedited, target))
        mask = (target - unedited).abs().amax(-1) > 0.1
        n_px += int(mask.sum())
        se_student += float(((edited - target) ** 2)[mask].sum())
        se_teacher += float(((unedited - target) ** 2)[mask].sum())
    check(n_px >= 100, f"the edit changes only {n_px} pixels of 4 val views")
    edit_student = -10.0 * np.log10(se_student / (3 * n_px))
    edit_teacher = -10.0 * np.log10(se_teacher / (3 * n_px))
    print(f"[seal] 4 val poses against the mapped teacher: student "
          f"{np.mean(ps_student):.2f} dB {[round(v, 2) for v in ps_student]}, "
          f"unedited teacher {np.mean(ps_teacher):.2f} dB "
          f"{[round(v, 2) for v in ps_teacher]}; on the {n_px} pixels the "
          f"edit changes: student {edit_student:.2f} dB, unedited teacher "
          f"{edit_teacher:.2f} dB")
    check(np.mean(ps_student) >= MIN_EDIT_PSNR,
          f"student PSNR {np.mean(ps_student):.2f} < {MIN_EDIT_PSNR}")
    check(edit_teacher < edit_student,
          "on the edited pixels the unedited teacher is as close to the "
          "target as the student: the edit did not take")

    forced = hack_bitfield(torch.zeros_like(st.state.occ.bitfield),
                           st._hack_bytes, st._hack_masks)
    bits = st.state.occ.bitfield
    held = int((((bits & forced) == forced) & (forced != 0)).sum())
    n_forced = int((forced != 0).sum())
    print(f"[seal] after restore_grid {held} of {n_forced} force-filled "
          f"bytes are still fully set")
    check(n_forced > 0 and held < n_forced,
          "restore_grid left the force-fill in the bitfield")

    # the edited test views through K4
    test = load_dataset(cli, "test", device=dev)
    off = [st.render_image(p, test.h, test.w) for p in test.poses]
    st.eval_opts = dataclasses.replace(st.eval_opts, tl_kernel=True)
    before = len(st.render_stats)
    on = [st.render_image(p, test.h, test.w) for p in test.poses]
    st.eval_opts = dataclasses.replace(st.eval_opts, tl_kernel=False)
    d_img = max(float((a[0] - b[0]).abs().max()) for a, b in zip(on, off))
    d_dep = max(float((a[1] - b[1]).abs().max()) for a, b in zip(on, off))
    n_chunks = -(-test.h * test.w // st.cfg.eval_chunk)
    expect = len(test) * n_chunks + sum(
        s_["chunks_rendered"] for s_ in st.render_stats[before:])
    k4 = ladder_plan.launches
    print(f"[seal] edited test views with K4 vs without: image max diff "
          f"{d_img:.3e}, depth max diff {d_dep:.3e}; K4 launches {k4}")
    check(d_img <= 1e-5 and d_dep <= 1e-4,
          f"edited views differ with K4: {d_img} {d_dep}")
    check(k4 > 0 and k4 == expect, f"K4 launches {k4} != {expect}")
    return fwd, bwd, k4


def pth_round_trip(tr, ws):
    """Phases 9-10, end: the trained params through export_torch_ngp and
    import_torch_ngp into a fresh params tree. The native (bucket) layout
    must come back leaf for leaf bit-identical; a padded (pallas) layout
    loses its never-addressed padding rows (zeros on import), so there the
    tables must encode 2^20 random points bit-identically and the MLP
    leaves come back bit-identical."""
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.ops.hash_encode import hash_encode
    from seal3d_tpu_torch.train.checkpoint import (export_torch_ngp,
                                                   flatten_tree,
                                                   import_torch_ngp, map_tree)

    cfg = tr.fcfg.grid
    path = os.path.join(ws, "ngp.pth")
    export_torch_ngp(path, tr.state.params, step=int(tr.state.step),
                     grid_cfg=cfg)
    fresh = ngp.init(tr.fcfg, generator=torch.Generator().manual_seed(7))
    fresh = map_tree(fresh, lambda _, t: t.to(tr.device))
    loaded = dict(flatten_tree(import_torch_ngp(path, fresh, grid_cfg=cfg)))
    padded = cfg.backend == "pallas"
    x = torch.rand((2**20, 3), device=tr.device,
                   generator=torch.Generator(device=tr.device).manual_seed(3))
    same, differ = [], []
    for k, v in flatten_tree(tr.state.params):
        if padded and k in ("encoder", "encoder_color"):
            with torch.no_grad():
                ok = torch.equal(hash_encode(v, x, cfg),
                                 hash_encode(loaded[k], x, cfg))
            rows = int((v != loaded[k]).any(-1).sum())
            print(f"[pth {cfg.backend}] {k}: {rows} of {v.shape[0]} rows "
                  f"differ (padding), encode of 2^20 points "
                  f"{'bit-identical' if ok else 'DIFFERS'}")
        else:
            ok = torch.equal(v, loaded[k])
        (same if ok else differ).append(k)
    print(f"[pth {cfg.backend}] {os.path.getsize(path) / 2**20:.1f} MiB .pth "
          f"round trip: {len(same)} leaves bit-identical "
          f"{'(tables by their encode)' if padded else ''}, differ: {differ}")
    check(not differ, f".pth round trip ({cfg.backend}) changed {differ}")


def profile_steps(tr, n: int = 3):
    """torch.profiler over n train steps (after one warm-up step under the
    profiler): kernel launches, device busy time (kernels only), the host
    time and device-timeline span of the `step.*` and `render.*` ranges (the
    backward's kernels run on autograd's own thread, outside its range's
    span), and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for i in range(n + 1):
            tr.train_step()
            if i == n:
                torch.cuda.synchronize()
            prof.step()
    events = traced[0]
    stage = ("step.", "render.")   # record_function ranges of the port
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(stage)),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / n
    print(f"[profile] one train step (flat_frac {tr.opts.flat_frac}, mean of "
          f"{n}): device busy {busy:.3f} ms in kernels, {launches:.0f} kernel "
          f"launches")
    spans = {}
    for e in events:   # a range's host time, and its span on the device
        if e.key.startswith(stage):
            host, dev = spans.get(e.key, (0.0, 0.0))
            if e.device_type == DeviceType.CUDA:
                dev += e.device_time_total
            else:
                host += e.cpu_time_total
            spans[e.key] = (host, dev)
    for key in sorted(spans):
        host, dev = spans[key]
        print(f"[profile]   {key:<18s} host {host / 1e3 / n:7.3f} ms, device "
              f"span {dev / 1e3 / n:7.3f} ms")
    for e in kernels[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:7.3f} ms "
              f"x{e.count // n:<4d} {e.key[:88]}")


if __name__ == "__main__":
    main(sys.argv[1:])
