"""Calling the hand-written CUDA kernels: the one C-call path of the
wrappers under ops/.

A wrapper declares each C entry point it calls once, as a `Kernel` with the
entry's name and its C arguments in order, one code each (spaces ignored):
`p` a pointer (pass a tensor, an address or None for NULL), `i` int32, `l`
int64, `f` float32, `s` the stream, or a ctypes type (a pointer to a
struct). Every entry point returns `cudaGetLastError()` after its launch.
`library(lib)` launches from another build of the kernels while a block
runs (`build_library(sources)`, to time other versions of csrc files beside
the tree's).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from seal3d_tpu_torch.runtime.build import load_library

_CODES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
          "f": ctypes.c_float, "s": ctypes.c_void_p}
# the build `library` routes to; process-wide, so that launches from other
# threads (autograd runs a CUDA backward on its own) take it too
_library = None


class Kernel:
    """One C entry point of the kernels' library."""

    def __init__(self, name: str, signature):
        codes = [c for c in signature if c != " "]
        self.name = name
        self.argtypes = [_CODES[c] if isinstance(c, str) else c for c in codes]
        self.stream_at = codes.index("s")
        codes.pop(self.stream_at)
        self._pointers = [i for i, c in enumerate(codes) if c == "p"]
        self._bound = {}    # library -> its entry point, types declared

    def bind(self, lib: ctypes.CDLL):
        fn = self._bound.get(lib)
        if fn is None:
            fn = self._bound[lib] = lib[self.name]
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        return fn

    def launch(self, counter, *args) -> None:
        """Run the entry on `args` (all its arguments but the stream) under
        the device guard of the first tensor among them, on that device's
        current stream; raise on a nonzero return, else count one launch on
        `counter.launches` (the public wrapper's)."""
        fn = self.bind(_library or load_library())
        c_args, device = list(args), None
        for i in self._pointers:
            a = args[i]
            if isinstance(a, torch.Tensor):
                c_args[i] = a.data_ptr()
                if device is None:
                    device = a.device
        at = self.stream_at
        with torch.cuda.device(device):
            c_args.insert(at, torch.cuda.current_stream().cuda_stream)
            rc = fn(*c_args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc}")
        counter.launches += 1


@contextlib.contextmanager
def library(lib: ctypes.CDLL):
    """Launch every Kernel from `lib`, in every thread, while the block
    runs."""
    global _library
    previous, _library = _library, lib
    try:
        yield
    finally:
        _library = previous
