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
   through the plain version (a reference on a small input).
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


def kernel_vs_plain(table, x, valid, cfg):
    """(max abs diff, kernel ms, plain ms); timed in turns plain, kernel,
    kernel, plain so clock drift hits both alike."""
    from seal3d_tpu_torch.ops.halo_encode import halo_encode, halo_encode_plain

    with torch.no_grad():
        err = float((halo_encode(table, x, valid, cfg)
                     - halo_encode_plain(table, x, valid, cfg)).abs().max())
        p1 = time_ms(lambda: halo_encode_plain(table, x, valid, cfg), 3)
        k1 = time_ms(lambda: halo_encode(table, x, valid, cfg))
        k2 = time_ms(lambda: halo_encode(table, x, valid, cfg))
        p2 = time_ms(lambda: halo_encode_plain(table, x, valid, cfg), 3)
    return err, (k1 + k2) / 2, (p1 + p2) / 2


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
    from seal3d_tpu_torch.render.renderer import march_eval
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
    mf = march_eval(rays["rays_o"][idx], rays["rays_d"][idx], st.occ.bitfield,
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


if __name__ == "__main__":
    main(sys.argv[1:])
