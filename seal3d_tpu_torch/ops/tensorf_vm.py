"""TensoRF's factor lookups: bilinear samples of a plane factor and linear
samples of a line factor (`sample_plane`, `sample_line`), and the VM
decomposition's three plane x line products at normalised points, summed
over the ranks (the density feature) or laid side by side (the colour
features), `vm_features`.

`sample_plane` and `sample_line` are the reference's explicit bilinear /
linear formula over four / two gathers, zero outside [-1, 1] (not
`F.grid_sample`), each one autograd Function whose backward scatters the
factor's cotangent with `index_add_` from the saved corner indices and
weights. CP, CCNeRF and the background nets call them.

`vm_features` replaces no Pallas kernel of the JAX package, which writes
the lookups as gathers and blends and leaves them to XLA. It picks its path
from the device, with no option:
- CPU tensors take `vm_features_plain`: `sample_plane` x `sample_line`,
  summed or concatenated, as the model composed them before the kernel;
- CUDA tensors take the hand-written kernel pair (csrc/tensorf_vm.cu, whose
  note says what bounds it and why it is laid out so), and anything the
  kernel does not take raises.
Both paths run under `span("tensorf.sample")`, their backwards under
`span("tensorf.scatter")`, and move this module's host counters
(`lookup_rows`, `scatter_rows`, ...) by the same amounts as calls are
issued; the kernel's backward also adds the components it sends to the L2
by atomics into the device counter `scatter_atomic_comps`. models/tensorf.py
binds the counters under the same names, so they are only ever changed in
place. The kernel's forward is the plain path's bit for bit but for the
order of the rank sum; its backward adds in another fp32 order, different
on every run.
"""

from __future__ import annotations

import ctypes

import torch

from seal3d_tpu_torch.runtime.kernels import Kernel
from seal3d_tpu_torch.utils.trace import span

MAX_CHUNKS = 256    # sum of ceil(R_i / 4): the kernels' threads a point
# plane i spans world axes MAT_IDS[i]; line i spans axis VEC_IDS[i]
MAT_IDS = ((0, 1), (0, 2), (1, 2))
VEC_IDS = (2, 1, 0)

# the factor lookups' work over the process, counted on the host as calls
# are issued (no device sync), by factor kind: rows x components gathered
# forward (`lookup_rows`) and scattered by the backward (`scatter_rows`),
# and the rows alone (`lookup_points`, `scatter_points`)
lookup_rows = {"plane": 0, "line": 0}
lookup_points = {"plane": 0, "line": 0}
scatter_rows = {"plane": 0, "line": 0}
scatter_points = {"plane": 0, "line": 0}
# the components the VM kernel's backward sent to the L2 by atomics (its
# run merge sends fewer than the 4 a plane row and 2 a line row that
# `scatter_rows` counts), by device: an int64 device tensor made on first
# use, added to on the device (read it after a sync)
scatter_atomic_comps = {}


# ------------------------------------------------------- interpolation cores

def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as min(max(x, lo), hi): at x == lo or hi the gradient is
    split in half, as JAX's is. The bounds are filled on x's device
    (`new_full`): a tensor made from host data would be a blocking copy."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _plane_corners(cx, cy, h: int, w: int, align_corners: bool):
    """(inside mask, first corner's flat index, fx, fy) of bilinear lookups
    at coords in [-1, 1]; cx indexes W, cy indexes H."""
    inside = (cx.abs() <= 1.0) & (cy.abs() <= 1.0)
    if align_corners:
        x = (_clip(cx, -1.0, 1.0) + 1.0) * 0.5 * (w - 1)
        y = (_clip(cy, -1.0, 1.0) + 1.0) * 0.5 * (h - 1)
    else:
        x = _clip((cx + 1.0) * 0.5 * w - 0.5, 0.0, w - 1.0)
        y = _clip((cy + 1.0) * 0.5 * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(y).to(torch.int64).clamp(0, h - 2)
    return inside, y0 * w + x0, x - x0, y - y0


def _plane_blend(v, fx, fy, inside):
    v00, v01, v10, v11 = v
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return out * inside[None, :]


def _line_corners(c, d: int, align_corners: bool):
    """(inside mask, first corner's index, fx) of linear lookups."""
    inside = c.abs() <= 1.0
    if align_corners:
        x = (_clip(c, -1.0, 1.0) + 1.0) * 0.5 * (d - 1)
    else:
        x = _clip((c + 1.0) * 0.5 * d - 0.5, 0.0, d - 1.0)
    x0 = torch.floor(x).to(torch.int64).clamp(0, d - 2)
    return inside, x0, x - x0


def _line_blend(v, fx, inside):
    v0, v1 = v
    return (v0 * (1 - fx) + v1 * fx) * inside[None, :]


def _rows(g, inside):
    """The cotangent [R, N] of a lookup as [N, R] rows, zero outside: the
    scatters add whole rows of R components into a factor laid out [cells,
    R], so that neighbouring threads add into neighbouring addresses where
    the [R, cells] layout has the rows of one cell, which neighbouring
    points share, contend for one address."""
    return g.T.contiguous() * inside[:, None]


def _slope(u, lo: float, hi: float, scale: float):
    """d(`_clip`(u, lo, hi) * scale) / du: `scale` inside, half of it at
    either bound (the split of JAX's clip), zero outside."""
    return (((u > lo) & (u < hi)).to(u.dtype)
            + 0.5 * ((u == lo) | (u == hi)).to(u.dtype)) * scale


def _coord_slope(c, n: int, align_corners: bool):
    """d(position in cells) / d(coordinate) of `_plane_corners` /
    `_line_corners` along an axis of n cells."""
    if align_corners:
        return _slope(c, -1.0, 1.0, 0.5 * (n - 1))
    return _slope((c + 1.0) * 0.5 * n - 0.5, 0.0, n - 1.0, 0.5 * n)


class _SamplePlane(torch.autograd.Function):
    """Bilinear lookup of a plane factor: four gathers and the blend
    forward; backward, the factor's cotangent as four `index_add_` scatters
    of [N, R] rows (`_rows`) from the saved corner index, weights and inside
    mask. The coordinates and the gathered corners are kept only where the
    coordinates need a cotangent: the blend's derivative along each axis."""

    @staticmethod
    def forward(ctx, plane, cx, cy, align_corners):
        with span("tensorf.sample"):
            r, h, w = plane.shape
            lookup_rows["plane"] += cx.shape[0] * r
            lookup_points["plane"] += cx.shape[0]
            inside, i00, fx, fy = _plane_corners(cx, cy, h, w, align_corners)
            flat = plane.reshape(r, h * w)
            v = (flat.index_select(1, i00), flat.index_select(1, i00 + 1),
                 flat.index_select(1, i00 + w),
                 flat.index_select(1, i00 + w + 1))
            keep = (cx, cy, *v) if any(ctx.needs_input_grad[1:3]) else ()
            ctx.save_for_backward(i00, fx, fy, inside, *keep)
            ctx.shape, ctx.align_corners = (r, h, w), align_corners
            return _plane_blend(v, fx, fy, inside)

    @staticmethod
    def backward(ctx, g):
        with span("tensorf.scatter"):
            i00, fx, fy, inside, *coords = ctx.saved_tensors
            r, h, w = ctx.shape
            d_plane = d_cx = d_cy = None
            if ctx.needs_input_grad[0]:
                scatter_rows["plane"] += i00.shape[0] * r
                scatter_points["plane"] += i00.shape[0]
                gm = _rows(g, inside)
                g0, g1 = gm * (1 - fy)[:, None], gm * fy[:, None]
                acc = g.new_zeros((h * w, r))
                acc.index_add_(0, i00, g0 * (1 - fx)[:, None])
                acc.index_add_(0, i00 + 1, g0 * fx[:, None])
                acc.index_add_(0, i00 + w, g1 * (1 - fx)[:, None])
                acc.index_add_(0, i00 + w + 1, g1 * fx[:, None])
                d_plane = acc.T.contiguous().view(r, h, w)
            if coords:
                cx, cy, v00, v01, v10, v11 = coords
                gi = g * inside[None, :]
                d_fx = (gi * ((v01 - v00) * (1 - fy)
                              + (v11 - v10) * fy)).sum(0)
                d_fy = (gi * ((v10 - v00) * (1 - fx)
                              + (v11 - v01) * fx)).sum(0)
                d_cx = d_fx * _coord_slope(cx, w, ctx.align_corners)
                d_cy = d_fy * _coord_slope(cy, h, ctx.align_corners)
            return d_plane, d_cx, d_cy, None


class _SampleLine(torch.autograd.Function):
    """Linear lookup of a line factor: two gathers and the blend forward;
    backward, two `index_add_` scatters (as `_SamplePlane`)."""

    @staticmethod
    def forward(ctx, line, c, align_corners):
        with span("tensorf.sample"):
            r, d = line.shape
            lookup_rows["line"] += c.shape[0] * r
            lookup_points["line"] += c.shape[0]
            inside, x0, fx = _line_corners(c, d, align_corners)
            v = (line.index_select(1, x0), line.index_select(1, x0 + 1))
            keep = (c, *v) if ctx.needs_input_grad[1] else ()
            ctx.save_for_backward(x0, fx, inside, *keep)
            ctx.shape, ctx.align_corners = (r, d), align_corners
            return _line_blend(v, fx, inside)

    @staticmethod
    def backward(ctx, g):
        with span("tensorf.scatter"):
            x0, fx, inside, *coords = ctx.saved_tensors
            r, d = ctx.shape
            d_line = d_c = None
            if ctx.needs_input_grad[0]:
                scatter_rows["line"] += x0.shape[0] * r
                scatter_points["line"] += x0.shape[0]
                gm = _rows(g, inside)
                acc = g.new_zeros((d, r))
                acc.index_add_(0, x0, gm * (1 - fx)[:, None])
                acc.index_add_(0, x0 + 1, gm * fx[:, None])
                d_line = acc.T.contiguous()
            if coords:
                c, v0, v1 = coords
                d_fx = (g * inside[None, :] * (v1 - v0)).sum(0)
                d_c = d_fx * _coord_slope(c, d, ctx.align_corners)
            return d_line, d_c, None


def sample_plane(plane: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                 align_corners: bool = True) -> torch.Tensor:
    """Bilinear sample of [R, H, W] at coords in [-1, 1] (zero outside); cx
    indexes W, cy indexes H. Returns [R, N]."""
    return _SamplePlane.apply(plane, cx, cy, align_corners)


def sample_line(line: torch.Tensor, c: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """Linear sample of [R, D] at coords in [-1, 1] (zero outside).
    Returns [R, N]."""
    return _SampleLine.apply(line, c, align_corners)


# ------------------------------------------------------------ the VM pairs

def vm_features_plain(mats, vecs, xn: torch.Tensor, align_corners=True,
                      reduce=True) -> torch.Tensor:
    """The plain composition: mats three [R_i, H_i, W_i] planes, vecs three
    [R_i, D_i] lines, xn [N, 3] in [-1, 1] (zero outside) -> the density
    feature [N] (reduce) or the colour features [sum R_i, N]."""
    parts = []
    for i in range(3):
        m0, m1 = MAT_IDS[i]
        parts.append(sample_plane(mats[i], xn[:, m0], xn[:, m1],
                                  align_corners)
                     * sample_line(vecs[i], xn[:, VEC_IDS[i]],
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


# factors, xn, out, N, reduce, align_corners, stream
_FWD = Kernel("tensorf_vm_fwd", [ctypes.POINTER(_Factors), *"pp lii s"])
# factors, xn, cotangent, d_xn, scatter_atomic_comps, N, reduce,
# align_corners, stream
_BWD = Kernel("tensorf_vm_bwd", [ctypes.POINTER(_Factors), *"pppp lii s"])


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
            n = xn.shape[0]
            for m, v in zip(factors[:3], factors[3:]):
                lookup_rows["plane"] += n * m.shape[0]
                lookup_points["plane"] += n
                lookup_rows["line"] += n * v.shape[0]
                lookup_points["line"] += n
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
            n = xn.shape[0]
            for i, (r, *_) in enumerate(ctx.shapes):
                for kind, j in (("plane", 3 + i), ("line", 6 + i)):
                    if want[j]:
                        scatter_rows[kind] += n * r
                        scatter_points[kind] += n
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
        _FWD.launch(vm_features, f, xn, out, n, int(reduce),
                    int(align_corners))
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
        _BWD.launch(vm_features_bwd, f, xn, g, d_xn,
                    _comps_counter(xn.device), n, int(reduce),
                    int(align_corners))
    out = []
    for j, (r, h, w, d) in enumerate(shapes * 2):
        cells = (h, w) if j < 3 else (d,)
        out.append(grads[j][:, :r].T.contiguous().view(r, *cells))
    return out, d_xn


vm_features.launches = 0
vm_features_bwd.launches = 0


def _comps_counter(dev) -> torch.Tensor:
    """`scatter_atomic_comps` on `dev`: an int64 device tensor, made on
    first use."""
    if dev not in scatter_atomic_comps:
        scatter_atomic_comps[dev] = torch.zeros((), dtype=torch.int64,
                                                device=dev)
    return scatter_atomic_comps[dev]
