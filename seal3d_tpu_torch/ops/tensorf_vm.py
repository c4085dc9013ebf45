"""TensoRF VM factor lookups: the three plane x line products of a VM
decomposition at normalised points, summed over the ranks (the density
feature) or laid side by side (the colour features).

Replaces no Pallas kernel of the JAX package, which writes the lookups as
gathers and blends and leaves them to XLA. `vm_features` picks its path from
the device, with no option:
- CPU tensors take `vm_features_plain`: `sample_plane` x `sample_line`
  (models/tensorf.py), summed or concatenated, as the model composed them
  before the kernel;
- CUDA tensors take the hand-written kernel pair (csrc/tensorf_vm.cu, whose
  note says what bounds it and why it is laid out so), and anything the
  kernel does not take raises.
The kernel runs under the same ranges as the plain path's Functions
(`tensorf.sample` forward, `tensorf.scatter` backward) and moves the same
host counters of models/tensorf.py by the same amounts; the backward also
adds the components it sends to the L2 by atomics into the device counter
`scatter_atomic_comps` there. Its forward is the plain path's bit for bit
but for the order of the rank sum; its backward adds in another fp32
order, different on every run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from seal3d_tpu_torch.utils.trace import span

MAX_CHUNKS = 256    # sum of ceil(R_i / 4): the kernels' threads a point


def _model():
    """models/tensorf.py, which imports this module (so not at the top)."""
    from seal3d_tpu_torch.models import tensorf

    return tensorf


def vm_features_plain(mats, vecs, xn: torch.Tensor, align_corners=True,
                      reduce=True) -> torch.Tensor:
    """The plain composition: mats three [R_i, H_i, W_i] planes, vecs three
    [R_i, D_i] lines, xn [N, 3] in [-1, 1] (zero outside) -> the density
    feature [N] (reduce) or the colour features [sum R_i, N]."""
    tf = _model()
    parts = []
    for i in range(3):
        m0, m1 = tf.MAT_IDS[i]
        parts.append(tf.sample_plane(mats[i], xn[:, m0], xn[:, m1],
                                     align_corners)
                     * tf.sample_line(vecs[i], xn[:, tf.VEC_IDS[i]],
                                      align_corners))
    if not reduce:
        return torch.cat(parts, dim=0)
    feat = 0.0
    for part in parts:
        feat = feat + part.sum(0)
    return feat


def vm_features(mats, vecs, xn: torch.Tensor, align_corners=True,
                reduce=True) -> torch.Tensor:
    """`vm_features_plain`'s result, differentiable in the six factors and
    xn: the plain composition for CPU tensors, the kernel pair for CUDA
    tensors (counted in `vm_features.launches` and
    `vm_features_bwd.launches`). The colour features come as a [sum R, N]
    view of an [N, sum R] tensor, so `feats.T @ basis` reads them in
    place."""
    if xn.device.type == "cpu":
        return vm_features_plain(mats, vecs, xn, align_corners, reduce)
    if xn.device.type != "cuda":
        raise ValueError(f"vm_features: unsupported device {xn.device}")
    _check(mats, vecs, xn)
    out = _VMFeatures.apply(xn.contiguous(), bool(align_corners),
                            bool(reduce), *mats, *vecs)
    return out if reduce else out.T


def _check(mats, vecs, xn):
    dev = xn.device
    if len(mats) != 3 or len(vecs) != 3 or xn.dim() != 2 or xn.shape[1] != 3:
        raise ValueError(f"vm_features needs three planes, three lines and "
                         f"xn [N, 3]; got {len(mats)}, {len(vecs)}, "
                         f"{tuple(xn.shape)}")
    for t in (xn, *mats, *vecs):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"vm_features needs f32 tensors on {dev}; got "
                             f"{t.dtype} on {t.device}")
    for m, v in zip(mats, vecs):
        if (m.dim() != 3 or v.dim() != 2 or m.shape[0] != v.shape[0]
                or m.shape[0] < 1 or min(m.shape[1:]) < 2 or v.shape[1] < 2):
            raise ValueError(f"vm_features needs planes [R, H, W] and lines "
                             f"[R, D] of one rank, H, W, D >= 2; got "
                             f"{tuple(m.shape)}, {tuple(v.shape)}")
    if sum(-(-m.shape[0] // 4) for m in mats) > MAX_CHUNKS:
        raise ValueError(f"vm_features takes at most {4 * MAX_CHUNKS} ranks "
                         f"in all; got {[m.shape[0] for m in mats]}")


def _cell_rows(f: torch.Tensor) -> torch.Tensor:
    """A factor [R, cells...] as [cells, R4] rows, R4 = R rounded up to 4,
    the padding zero."""
    r = f.shape[0]
    flat = f.reshape(r, -1).T
    r4 = -(-r // 4) * 4
    if r4 == r:
        return flat.contiguous()
    rows = f.new_zeros((flat.shape[0], r4))
    rows[:, :r] = flat
    return rows


class _Factors(ctypes.Structure):
    """csrc/tensorf_vm.cu's VMFactors."""
    _fields_ = [("mat", ctypes.c_void_p * 3), ("vec", ctypes.c_void_p * 3),
                ("gmat", ctypes.c_void_p * 3), ("gvec", ctypes.c_void_p * 3),
                ("r", ctypes.c_int * 3), ("h", ctypes.c_int * 3),
                ("w", ctypes.c_int * 3), ("d", ctypes.c_int * 3)]


def _factors(shapes, rows, grads=None) -> _Factors:
    f = _Factors()
    for i, ((r, h, w, d), m, v) in enumerate(zip(shapes, rows[:3], rows[3:])):
        f.mat[i], f.vec[i] = m.data_ptr(), v.data_ptr()
        if grads is not None:
            f.gmat[i], f.gvec[i] = grads[i].data_ptr(), grads[3 + i].data_ptr()
        f.r[i], f.h[i], f.w[i], f.d[i] = r, h, w, d
    return f


class _VMFeatures(torch.autograd.Function):
    """The kernel pair. Saves xn and the factors' [cells, R4] rows; the
    backward recomputes the corners and blends."""

    @staticmethod
    def forward(ctx, xn, align_corners, reduce, *factors):
        with span("tensorf.sample"):
            tf = _model()
            n = xn.shape[0]
            for m, v in zip(factors[:3], factors[3:]):
                tf.lookup_rows["plane"] += n * m.shape[0]
                tf.lookup_points["plane"] += n
                tf.lookup_rows["line"] += n * v.shape[0]
                tf.lookup_points["line"] += n
            rows = [_cell_rows(f) for f in factors]
            shapes = [(m.shape[0], m.shape[1], m.shape[2], v.shape[1])
                      for m, v in zip(factors[:3], factors[3:])]
            out = vm_features_fwd(rows, shapes, xn, align_corners, reduce)
            ctx.save_for_backward(xn, *rows)
            ctx.shapes = shapes
            ctx.align_corners, ctx.reduce = align_corners, reduce
            return out

    @staticmethod
    def backward(ctx, g):
        with span("tensorf.scatter"):
            xn, *rows = ctx.saved_tensors
            want = ctx.needs_input_grad
            tf = _model()
            n = xn.shape[0]
            for i, (r, *_) in enumerate(ctx.shapes):
                for kind, j in (("plane", 3 + i), ("line", 6 + i)):
                    if want[j]:
                        tf.scatter_rows[kind] += n * r
                        tf.scatter_points[kind] += n
            d_factors, d_xn = vm_features_bwd(
                rows, ctx.shapes, xn, g.contiguous(), ctx.align_corners,
                ctx.reduce, want[0])
            return (d_xn, None, None,
                    *[d if w else None for d, w in zip(d_factors, want[3:])])


def vm_features_fwd(rows, shapes, xn, align_corners, reduce):
    """Kernel forward: rows the six factors' [cells, R4] rows (three planes,
    three lines), shapes (R, H, W, D) a pair, xn [N, 3] -> [N] (reduce) or
    [N, sum R]; counted in `vm_features.launches`."""
    n = xn.shape[0]
    sum_r = sum(s[0] for s in shapes)
    out = torch.empty((n,) if reduce else (n, sum_r), dtype=torch.float32,
                      device=xn.device)
    if n:
        f = _factors(shapes, rows)
        _run("tensorf_vm_fwd", xn, ctypes.byref(f), xn.data_ptr(),
             out.data_ptr(), n, int(reduce), int(align_corners))
        vm_features.launches += 1
    return out


def vm_features_bwd(rows, shapes, xn, g, align_corners, reduce, need_dx):
    """Kernel backward: the cotangents of the six factors ([R, H, W] planes,
    [R, D] lines) and of xn [N, 3] (None unless need_dx) from g [N] (reduce)
    or [N, sum R]; counted in `vm_features_bwd.launches`."""
    n = xn.shape[0]
    sum_r = sum(s[0] for s in shapes)
    if g.shape != ((n,) if reduce else (n, sum_r)) or g.dtype != torch.float32:
        raise ValueError(f"vm_features_bwd: cotangent {g.dtype} "
                         f"{tuple(g.shape)} for {n} points of {sum_r} "
                         f"features (reduce={reduce})")
    sizes = [t.numel() for t in rows]
    scratch = torch.zeros(sum(sizes), dtype=torch.float32, device=xn.device)
    grads = [s.view(t.shape) for s, t in zip(scratch.split(sizes), rows)]
    d_xn = (torch.empty((n, 3), dtype=torch.float32, device=xn.device)
            if need_dx else None)
    if n:
        f = _factors(shapes, rows, grads)
        _run("tensorf_vm_bwd", xn, ctypes.byref(f), xn.data_ptr(),
             g.data_ptr(), 0 if d_xn is None else d_xn.data_ptr(),
             _comps_counter(xn.device).data_ptr(), n, int(reduce),
             int(align_corners))
        vm_features_bwd.launches += 1
    out = []
    for j, (r, h, w, d) in enumerate(shapes * 2):
        cells = (h, w) if j < 3 else (d,)
        out.append(grads[j][:, :r].T.contiguous().view(r, *cells))
    return out, d_xn


vm_features.launches = 0
vm_features_bwd.launches = 0


def _comps_counter(dev) -> torch.Tensor:
    """models/tensorf.py's `scatter_atomic_comps` on `dev`: an int64 device
    tensor, made on first use."""
    counters = _model().scatter_atomic_comps
    if dev not in counters:
        counters[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return counters[dev]


@functools.cache
def _entry(name: str):
    from seal3d_tpu_torch.runtime.build import load_library

    fn = getattr(load_library(), name)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = ctypes.POINTER(_Factors)
    fn.argtypes = ([f, p, p, i64, i32, i32, p] if name == "tensorf_vm_fwd"
                   else [f, p, p, p, p, i64, i32, i32, p])
    fn.restype = ctypes.c_int
    return fn


def _run(name, xn, *args):
    """Launch entry `name` on the current stream; raise on a CUDA error."""
    with torch.cuda.device(xn.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
