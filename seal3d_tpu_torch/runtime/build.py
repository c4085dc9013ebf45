"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every `*.cu` file under `seal3d_tpu_torch/csrc/` is compiled by its own nvcc
process, all started together, and the objects are linked into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds) under `seal3d_tpu_torch/_build/`. The library is named by a digest
of the sources, the headers they include (`*.cuh`) and the flags, so an
edited source or header never loads a stale library. Wrappers pass tensor
pointers and the current stream as `c_void_p`; each C entry point returns
`cudaGetLastError()` after its launch.

Host libraries (`csrc/*.cpp`, the mesh extractor) take the `g++` path:
`load_host_library(name)` compiles `csrc/<name>.cpp` into
`_build/lib<name>_<digest>.so` at first use, named by a digest of the source
and the flags in the same way.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


def build_library(sources: Optional[Sequence[str]] = None) -> BuildResult:
    """Compile csrc/*.cu into _build/ unless an identical build exists. With
    `sources`, compile those files instead (other versions of csrc files,
    to time beside the tree's: they find the shared headers in csrc/)."""
    sources = sorted(sources if sources is not None
                     else glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR,
                       f"libseal3d_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return BuildResult(out, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c",
                                   "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({p.returncode}):\n{log}")
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file
    return BuildResult(out, time.perf_counter() - t0, "".join(logs))


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    return ctypes.CDLL(build_library().path)


def build_host_library(name: str) -> BuildResult:
    """Compile csrc/<name>.cpp with g++ into _build/ unless an identical
    build exists."""
    src = os.path.join(CSRC_DIR, f"{name}.cpp")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return BuildResult(out, 0.0, "")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: csrc/{name}.cpp cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, src, "-o", lib],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {name}.cpp ({proc.returncode}):"
                               f"\n{proc.stderr}")
        os.replace(lib, out)
    return BuildResult(out, time.perf_counter() - t0, proc.stderr)


@functools.cache
def load_host_library(name: str) -> ctypes.CDLL:
    """The host library of csrc/<name>.cpp, built on first call in this
    process."""
    return ctypes.CDLL(build_host_library(name).path)
