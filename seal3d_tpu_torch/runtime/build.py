"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every `*.cu` file under `seal3d_tpu_torch/csrc/` is compiled by one nvcc call
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds) under `seal3d_tpu_torch/_build/`, named by a digest of
the sources and flags so an edited source never loads a stale library.
Wrappers pass tensor pointers and the current stream as `c_void_p`; each C
entry point returns `cudaGetLastError()` after its launch.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class BuildResult(NamedTuple):
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc/ptxas output (registers, spills) of a fresh build


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build_library() -> BuildResult:
    """Compile csrc/*.cu into _build/ unless an identical build exists."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR,
                       f"libseal3d_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return BuildResult(out, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return BuildResult(out, seconds, proc.stdout + proc.stderr)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    return ctypes.CDLL(build_library().path)
