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
The line before the last is the kernel table as JSON; the last line is
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


def compare(kernel, plain):
    """(max abs diff, max |plain|, kernel ms, plain ms) of two no-argument
    callables; timed in turns plain, kernel, kernel, plain so clock drift
    hits both alike."""
    with torch.no_grad():
        ref = plain()
        err = float((kernel() - ref).abs().max())
        scale = float(ref.abs().max())
        del ref
        p1 = time_ms(plain, 3)
        k1 = time_ms(kernel)
        k2 = time_ms(kernel)
        p2 = time_ms(plain, 3)
    return err, scale, (k1 + k2) / 2, (p1 + p2) / 2


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
    print(f"[build] K1 library {os.path.basename(built.path)}: "
          f"{time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        ws = args.workspace or tmp
        kernels = run_phases(dev, ws)
        bwd_err, bwd_ms, bwd_plain_ms = k1_bwd_phase(dev)
        _, fwd_launches, bwd_launches = train_phase(os.path.join(ws, "train"))
        hash_rows = hash_kernels_phase(dev)
        for backend in ("bucket", "pallas"):
            tr, fwd, bwd = train_phase(os.path.join(ws, f"train_{backend}"),
                                       backend)
            pth_round_trip(tr, os.path.join(ws, f"train_{backend}"))
            hash_rows[0]["launches"] += fwd
            hash_rows[1]["launches"] += bwd
            del tr
    kernels[0]["launches"] += fwd_launches
    kernels.append({"name": "halo_encode_bwd", "route": "cuda",
                    "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
                    "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:429",
                    "launches": bwd_launches, "max_abs_err": bwd_err,
                    "ms": bwd_ms, "plain_ms": bwd_plain_ms})
    kernels.extend(hash_rows)
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
    return [{"name": "halo_encode_fwd", "route": "cuda",
             "source": "seal3d_tpu_torch/csrc/halo_encode.cu",
             "replaces": "seal3d_tpu/ops/pallas/halo_encode.py:368",
             "launches": launches, "max_abs_err": max_err,
             "ms": ms, "plain_ms": plain_ms}]


def k1_bwd_phase(dev):
    """Phase 6 -> (max abs err, kernel ms, plain ms) of the M=196,608 F=4
    case (the train step's shape); every case is checked."""
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
                result = (err, ms, plain_ms)
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
                fwd.update(ms=ms, plain_ms=plain_ms)
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
                print(f"[hash bwd] {backend} T=2^{log2t} M={mb} L=16 F={f}: "
                      f"max_abs_err {err:.3e} (max |grad| {scale:.3e}, rel "
                      f"{err / scale:.3e}); kernel {ms:.3f} ms plain "
                      f"{plain_ms:.3f} ms")
                check(err <= BWD_RTOL * scale,
                      f"hash bwd {backend} M={mb} F={f} disagrees with "
                      f"plain: {err} of {scale}")
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
                if backend == "bucket" and mb == 4096 * 48 and f == 4:
                    bwd.update(ms=ms, plain_ms=plain_ms)
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
    print(f"[hash] stacking the two T=2^19 tables (torch.cat, "
          f"{4 * 4 * cfg.total_params / 2**20:.1f} MiB out): {cat_ms:.3f} ms "
          f"per field call")
    print(f"[hash bwd] contention, bucket T=2^19 M={mb} F=4 uniform points: "
          f"all 16 levels {all_ms:.3f} ms ({all_ms / 16 * 1e3:.1f} us per "
          f"level), the {dense} dense levels alone {coarse_ms:.3f} ms "
          f"({coarse_ms / dense * 1e3:.1f} us per level)")
    return [fwd, bwd]


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
