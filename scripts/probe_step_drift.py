#!/usr/bin/env python3
"""How a train step's time drifts over a long process on the card.

    python scripts/probe_step_drift.py [--field ngp|tensorf] [--seconds 150]
        [--block 100] [--profile-after 60]

Trains one field (NGP at the -O width, or TensoRF VM at the CLI's full
width) on the synthetic scene at 256x256 with the analytic occupancy and a
fixed flat_frac of 0.375, and prints, for each block of `--block` steps,
the ms per step (host clock around the block, ending in a sync), the host's
mean CPU clock (/proc/cpuinfo) and the card's SM clock and power draw
(nvidia-smi). With `--profile-after S` one step runs under torch.profiler
(CPU and CUDA activities) once S seconds have passed, so that a slowdown
the profiler leaves behind shows against one that time alone brings.
Needs a CUDA device; run from the repo root.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from seal3d_tpu_torch.data.synthetic import SyntheticScene  # noqa: E402
from seal3d_tpu_torch.models import ngp, tensorf  # noqa: E402
from seal3d_tpu_torch.render.occupancy import (occupancy_init,  # noqa: E402
                                               occupancy_update)
from seal3d_tpu_torch.render.renderer import RenderOptions  # noqa: E402
from seal3d_tpu_torch.train.tensorf_trainer import TensoRFTrainer  # noqa: E402
from seal3d_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

OPTS = dict(bound=1.0, dt_gamma=0.0, max_steps=512, budget_per_ray=48,
            num_candidates=256, coarse_steps=64, occ_stride=4, min_near=0.05,
            flat_frac=0.375)


def cpu_mhz() -> float:
    with open("/proc/cpuinfo") as f:
        vals = [float(line.split(":")[1]) for line in f
                if line.startswith("cpu MHz")]
    return sum(vals) / max(len(vals), 1)


def card_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--field", choices=["ngp", "tensorf"], default="ngp")
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--block", type=int, default=100)
    ap.add_argument("--profile-after", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_step_drift: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ds = SyntheticScene().make_dataset(n_views=8, h=256, w=256, seed=0,
                                       device=dev)
    opts, cfg = RenderOptions(**OPTS), TrainConfig(max_steps=30000)
    if args.field == "tensorf":
        tr = TensoRFTrainer(tensorf.TensoRFConfig(), opts, cfg, dataset=ds,
                            device=dev, upsample_steps=(), shrink_step=None)
    else:
        tr = Trainer(ngp, ngp.NGPConfig(grid_backend="halo", gridtype="wrap",
                                        log2_hashmap_size=15),
                     opts, cfg, dataset=ds, device=dev)
    tr.init_state()
    tr.state = tr.state._replace(occ=occupancy_update(
        occupancy_init(1, device=dev), SyntheticScene().density, 1.0,
        density_thresh=0.01, generator=torch.Generator(dev).manual_seed(2)))
    for _ in range(10):
        tr.train_step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    profiled = args.profile_after is None
    while time.perf_counter() - start < args.seconds:
        if not profiled and time.perf_counter() - start >= args.profile_after:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                tr.train_step()
                torch.cuda.synchronize()
            profiled = True
            print(f"[drift] {time.perf_counter() - start:7.1f} s: one step "
                  f"under torch.profiler")
        t0 = time.perf_counter()
        for _ in range(args.block):
            tr.train_step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / args.block * 1e3
        print(f"[drift] {time.perf_counter() - start:7.1f} s: {args.field} "
              f"{ms:.2f} ms a step; host CPU {cpu_mhz():.0f} MHz; card "
              f"{card_clocks()}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
