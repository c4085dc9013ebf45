"""The NGP background net's PSNR cost on chip_smoke phase 22's Blender tree,
cut to a CPU size, in both packages.

chip_smoke phase 22 writes its tree (the synthetic scene at random orbit
poses, nerf_synthetic's layout) at --hw pixels a side, RGB on white; then
`main_nerf.py` (the JAX package) and `python -m seal3d_tpu_torch.main_nerf`
(the port, --device cpu) each train phase 22's recipe on it, with and
without `--bg_radius`, each in a process of its own, and the script prints
every val PSNR and the gap (plain minus background net) in each package.
Both packages run the `xla` grid backend at T=2^15 (the JAX package's -O
backend is a Pallas kernel, which runs interpreted off the TPU).

    python scripts/bg_gap_witness.py --hw 200 --iters 576 --out <dir>

The last line is a JSON object {"hw", "iters", "psnr": {run: dB},
"gap_db": {package: dB}}.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tree(out, hw):
    sys.path.insert(0, ROOT)
    import chip_smoke

    tree = os.path.join(out, f"tree_{hw}")
    if not os.path.exists(os.path.join(tree, "transforms_test.json")):
        chip_smoke.write_blender_tree("cpu", os.path.join(out, "rgba"),
                                      tree, hw=hw)
    return tree


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=200)
    ap.add_argument("--iters", type=int, default=576)
    ap.add_argument("--bg_radius", type=float, default=32.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", type=int, default=2,
                    help="CLI processes at once")
    ap.add_argument("--threads", type=int, default=2,
                    help="CPU threads a process")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    tree = write_tree(args.out, args.hw)
    recipe = [tree, "-O", "--grid_backend", "xla", "--log2_hashmap_size",
              "15", "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0",
              "--min_near", "0.05", "--max_steps", "512", "--iters",
              str(args.iters)]
    clis = {"jax": [sys.executable, os.path.join(ROOT, "main_nerf.py")],
            "port": [sys.executable, "-m", "seal3d_tpu_torch.main_nerf",
                     "--device", "cpu"]}
    runs = {}
    for pkg, cli in clis.items():
        for tag, extra in (("plain", []),
                           ("bg", ["--bg_radius", str(args.bg_radius)])):
            ws = os.path.join(args.out, f"{pkg}_{tag}_{args.hw}")
            runs[f"{pkg}_{tag}"] = (cli + recipe + extra + ["--workspace", ws],
                                    ws)
    n = str(args.threads)
    env = dict(os.environ, OMP_NUM_THREADS=n, MKL_NUM_THREADS=n,
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=" + n,
               JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    psnr, pending, active = {}, list(runs.items()), []
    while pending or active:
        while pending and len(active) < args.jobs:
            name, (cmd, ws) = pending.pop(0)
            os.makedirs(ws, exist_ok=True)
            log = open(os.path.join(ws, "log.txt"), "w")
            active.append((name, subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log, time.perf_counter()))
        time.sleep(2)
        for item in list(active):
            name, proc, log, t0 = item
            if proc.poll() is None:
                continue
            active.remove(item)
            log.close()
            text = open(log.name).read()
            m = re.findall(r"\[eval\] PSNR ([0-9.]+)", text)
            if proc.returncode or not m:
                raise SystemExit(f"{name} failed (exit {proc.returncode}); "
                                 f"see {log.name}")
            psnr[name] = float(m[-1])
            print(f"[{name}] val PSNR {psnr[name]} dB "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    gap = {pkg: psnr[f"{pkg}_plain"] - psnr[f"{pkg}_bg"] for pkg in clis}
    print(json.dumps({"hw": args.hw, "iters": args.iters, "psnr": psnr,
                      "gap_db": gap}))


if __name__ == "__main__":
    main()
