"""PSNR against train steps at bound 2 (bench.py's wide_bound2 recipe).

Trains NGP (`halo` over the `wrap` grids, T=2^15, 16 levels) on
WideSyntheticScene at dt_gamma 1/128, max_steps 512, budget 48, 256
candidates, coarse 64, lr 3e-3, the adaptive budget, and prints at each step
count of --at the PSNR of bench.py's view (`evaluate(max_views=1)`: the
first training view) and of a held-out view, for each seed.

    # the port on the card, at the recipe's size
    python scripts/probe_bound2_steps.py --package port --device cuda \\
        --seeds 2 5 --at 448 800 1200 1600 2400
    # either package on the CPU at a reduced size (the JAX package with
    # its K1 replaced by the fp32 take-gather of its own tests)
    python scripts/probe_bound2_steps.py --package jax --rays 1024 --res 96
    python scripts/probe_bound2_steps.py --package port --device cpu \\
        --rays 1024 --res 96

The two packages draw their random numbers from different generators, so
their runs compare as runs, not step by step (tests/
test_torch_train_parity_bound2.py holds them together step by step).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPTS = dict(bound=2.0, dt_gamma=1 / 128, max_steps=512, budget_per_ray=48,
            num_candidates=256, min_near=0.05, coarse_steps=64)
FIELD = dict(bound=2.0, log2_hashmap_size=15, grid_backend="halo",
             gridtype="wrap")


def train_cfg(rays):
    return dict(lr=3e-3, max_steps=30000, num_rays=rays, eval_chunk=2**15,
                eval_budget_per_ray=64, eval_flat_frac=0.5, random_bg=False,
                adaptive_budget=True)


def jax_trainer(seed, rays, res):
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    jax.config.update("jax_platforms", "cpu")
    import pytest
    from test_torch_train_step import _k1_take_oracle

    from seal3d_tpu.data.synthetic import WideSyntheticScene
    from seal3d_tpu.models import ngp
    from seal3d_tpu.render.renderer import RenderOptions
    from seal3d_tpu.train.trainer import TrainConfig, Trainer

    _k1_take_oracle(pytest.MonkeyPatch())
    ds = WideSyntheticScene().make_dataset(n_views=12, h=res, w=res, seed=0)
    val = WideSyntheticScene().make_dataset(n_views=1, h=res, w=res, seed=1)
    tr = Trainer(ngp, ngp.NGPConfig(**FIELD), RenderOptions(**OPTS),
                 TrainConfig(**train_cfg(rays)), dataset=ds,
                 key=jax.random.PRNGKey(seed))
    tr.init_state()
    return tr, val, lambda n: tr.train(steps=n, log_every=10**9, silent=True,
                                       blocked=True)


def port_trainer(seed, rays, res, device):
    import torch

    from seal3d_tpu_torch.data.synthetic import WideSyntheticScene
    from seal3d_tpu_torch.models import ngp
    from seal3d_tpu_torch.render.renderer import RenderOptions
    from seal3d_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device(device)
    ds = WideSyntheticScene().make_dataset(n_views=12, h=res, w=res, seed=0,
                                           device=dev)
    val = WideSyntheticScene().make_dataset(n_views=1, h=res, w=res, seed=1,
                                            device=dev)
    tr = Trainer(ngp, ngp.NGPConfig(**FIELD), RenderOptions(**OPTS),
                 TrainConfig(**train_cfg(rays)), dataset=ds, seed=seed,
                 device=dev)
    tr.init_state()
    return tr, val, lambda n: tr.train(steps=n, log_every=10**9)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["port", "jax"], default="port")
    ap.add_argument("--device", default="cuda",
                    help="the port's torch device (the JAX package runs on "
                         "the CPU)")
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--res", type=int, default=192)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2])
    ap.add_argument("--at", type=int, nargs="+", default=[448])
    args = ap.parse_args()
    if args.package == "port" and args.device == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    where = args.device if args.package == "port" else "cpu"
    for seed in args.seeds:
        if args.package == "jax":
            tr, val, train = jax_trainer(seed, args.rays, args.res)
        else:
            tr, val, train = port_trainer(seed, args.rays, args.res,
                                          args.device)
        done, t0 = 0, time.perf_counter()
        for at in args.at:
            train(at - done)
            done = at
            p_bench, p_val = tr.evaluate(max_views=1), tr.evaluate(val)
            print(f"[bound2 steps] {args.package} ({where}) {args.rays} "
                  f"rays {args.res}x{args.res} seed {seed} step {at}: "
                  f"bench.py's "
                  f"view {p_bench:.2f} dB, held-out {p_val:.2f} dB "
                  f"({time.perf_counter() - t0:.0f} s so far)", flush=True)


if __name__ == "__main__":
    main()
