"""The one C-call path of the kernel wrappers (runtime/kernels.py) on the
CPU: a `Kernel` bound to a small host library built here with g++, so its
argument declaration, the stream's place among the arguments, the
tensor-to-pointer conversion, the launch counter, the error on a nonzero
return and `library`'s routing run without a card. The device guard and the
current stream are CUDA's, so the tests stand in for them."""

import contextlib
import ctypes
import subprocess
import threading
import types

import pytest
import torch

from seal3d_tpu_torch.runtime import kernels

# seen[0..3] = the stream, n, x[0] and this build's mark; returns rc
SOURCE = """
extern "C" int entry(const float* x, long long n, void* stream, int rc,
                     long long* seen) {
  seen[0] = (long long)stream; seen[1] = n; seen[2] = (long long)x[0];
  seen[3] = MARK;
  return rc;
}
extern "C" int other(void* stream) { return 0; }
"""
STREAM = 0x5EA1


def _build(tmp_path, name, mark, with_entry=True):
    src = tmp_path / f"{name}.cpp"
    text = SOURCE if with_entry else SOURCE[SOURCE.index('extern "C" int o'):]
    src.write_text(text.replace("MARK", str(mark)))
    lib = tmp_path / f"lib{name}.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-O1", str(src), "-o",
                    str(lib)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def host(tmp_path, monkeypatch):
    """The tree's library replaced by a host build (mark 1), and CUDA's
    device guard and current stream by stand-ins."""
    tree = _build(tmp_path, "tree", 1)
    monkeypatch.setattr(kernels, "load_library", lambda: tree)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=STREAM))
    return tmp_path


def _counter():
    def counted():
        pass
    counted.launches = 0
    return counted


def _launch(kernel, counter, rc=0):
    x = torch.tensor([7.0, 8.0])
    seen = torch.zeros(4, dtype=torch.int64)
    kernel.launch(counter, x, 3, rc, seen)
    return seen.tolist()


def test_signature_codes_become_argtypes():
    k = kernels.Kernel("entry", "pl s ip")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert k.argtypes == [p, i64, p, i32, p] and k.stream_at == 2
    struct = ctypes.POINTER(ctypes.c_int * 3)
    k = kernels.Kernel("entry", [struct, *"f s"])
    assert k.argtypes == [struct, ctypes.c_float, p] and k.stream_at == 2
    with pytest.raises(ValueError):
        kernels.Kernel("entry", "pli")          # no place for the stream


def test_launch_puts_the_stream_in_place_and_counts(host):
    k, counter = kernels.Kernel("entry", "pl s ip"), _counter()
    assert _launch(k, counter) == [STREAM, 3, 7, 1]
    assert counter.launches == 1
    tree = kernels.load_library()
    fn = k.bind(tree)
    assert fn.restype is ctypes.c_int and k.bind(tree) is fn   # bound once


def test_nonzero_return_raises_naming_the_entry(host):
    k, counter = kernels.Kernel("entry", "pl s ip"), _counter()
    with pytest.raises(RuntimeError,
                       match="entry launch failed: CUDA error 7"):
        _launch(k, counter, rc=7)
    assert counter.launches == 0


def test_library_routes_to_another_build_and_back(host):
    k, counter = kernels.Kernel("entry", "pl s ip"), _counter()
    other = _build(host, "other", 2)
    with kernels.library(other):
        assert _launch(k, counter)[3] == 2
    assert _launch(k, counter)[3] == 1
    assert counter.launches == 2


def test_library_routes_launches_from_other_threads(host):
    """Autograd runs the backward of CUDA tensors on a thread of its own:
    a launch there while the block runs takes the routed build too."""
    k, counter = kernels.Kernel("entry", "pl s ip"), _counter()
    other, seen = _build(host, "other", 2), []
    with kernels.library(other):
        worker = threading.Thread(target=lambda: seen.append(
            _launch(k, counter)))
        worker.start()
        worker.join()
    assert seen[0][3] == 2 and counter.launches == 1


def test_an_entry_missing_from_the_build_raises(host):
    k, counter = kernels.Kernel("entry", "pl s ip"), _counter()
    lacking = _build(host, "lacking", 3, with_entry=False)
    with kernels.library(lacking), pytest.raises(AttributeError):
        _launch(k, counter)
    assert counter.launches == 0
