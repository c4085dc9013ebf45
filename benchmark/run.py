"""Runs one cell of the benchmark of seal3d_tpu_torch once, from the root of
a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

and prints the result as the last line of standard output (see harness.py).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
# build and kernel caches at fixed paths inside the checkout: only a
# checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's other cores stay free for the
# program's own launch path, which bounds every cell here
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
