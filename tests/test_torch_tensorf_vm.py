"""The TensoRF VM lookups of `ops/tensorf_vm.py`: `vm_features_plain`
against the JAX package's `sample_plane` x `sample_line` composition on the
CPU (values, and the VJPs of the six factors and of xn), and, on the card,
the kernel pair against `vm_features_plain` at the published widths (300^3,
ranks 16 / 48) on a pretraining batch of grid-ordered shell points with a
padded tail, on random points, and at a rank that is not a multiple of 4.

The JAX package is imported inside the CPU tests alone, so the `cuda` tests
also run on a machine without JAX: python -m pytest --noconftest -m cuda
tests/test_torch_tensorf_vm.py

Tolerances, CPU (fp32 on both sides, the same formulas): the colour
features within 1e-6 of the largest (only the operations' rounding can
differ: the formulas are the same), the density feature within 1e-5 (the
rank sum's order), every cotangent within 1e-5 of its largest entry (sums
over ranks and over the points that share a cell, in another order).
On the card, the kernel against the plain path there: the colour features
within 1e-6 of the largest (the kernel follows the plain formulas'
operation order, so they are expected bit for bit), the density feature
within 1e-5 (the rank sum's order). Each element of a factor's cotangent
within 1e-4 of the sum of its terms' magnitudes: both paths add a cell's
terms in fp32 in an order that changes on every run (the kernel's
atomics, the plain path's `index_add_`), which keeps a sum of n terms
within about sqrt(n) 2^-24 of that magnitude; both sit at most 1.3e-5
from float64 here, where the shell batch's 220k padding rows, given
nonzero cotangents in the test, sum into one set of cells. xn's
cotangent within 1e-5 of its largest entry (a point's sum over its ranks,
on the same corners in both paths).
"""

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.models import tensorf as ttf
from seal3d_tpu_torch.ops import tensorf_vm as vm

KINDS = ("lookup_rows", "lookup_points", "scatter_rows", "scatter_points")


@pytest.fixture
def jtf():
    """The JAX package's TensoRF module (CPU tests only)."""
    from seal3d_tpu.models import tensorf

    return tensorf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def factors(res, ranks, seed, scale=0.4):
    """Three planes [R_i, res[b], res[a]] and lines [R_i, res[VEC_IDS[i]]],
    uniform in +-scale, as numpy arrays."""
    rng = np.random.default_rng(seed)
    mats, vecs = [], []
    for i, r in enumerate(ranks):
        a, b = ttf.MAT_IDS[i]
        mats.append(rng.uniform(-scale, scale, (r, res[b], res[a]))
                    .astype(np.float32))
        vecs.append(rng.uniform(-scale, scale, (r, res[ttf.VEC_IDS[i]]))
                    .astype(np.float32))
    return mats, vecs


def shell_batch(n, seed, step=0.005, useful=0.58):
    """A Seal-3D pretraining batch of n rows: a grid-ordered shell (z
    fastest, as `sample_grid_points`) at `step` from a seeded corner, its
    first `useful` share real and the rest repeating row 0 (the weight-0
    padding of a shell's last batch)."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-0.9, -0.3, 3)
    counts = (64, 80, 128)
    axes = [lo[d] + step * np.arange(counts[d]) for d in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    real = int(n * useful)
    rows = np.concatenate([np.arange(real), np.zeros(n - real, np.int64)])
    return pts[rows].astype(np.float32)


def mixed_points(n, seed):
    """Points in and outside [-1, 1]^3, with exact -1, 1 and 0 on each axis
    (the clip's ties) and a grid-ordered run with repeated padding rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.15, 1.15, (n, 3)).astype(np.float32)
    x[:9] = [[-1, 0.2, 0.3], [1, -0.4, 0.1], [0.5, -1, 0.6], [0.1, 1, -0.7],
             [0.3, 0.2, -1], [-0.6, 0.4, 1], [1, 1, 1], [0, 0, 0],
             [1.1, 0.2, 0.3]]
    run = shell_batch(64, seed + 1, step=0.02, useful=0.75)
    return np.concatenate([x, run])


def jax_features(jtf, mats, vecs, xn, align_corners, reduce):
    import jax.numpy as jnp

    parts = []
    for i in range(3):
        m0, m1 = jtf.MAT_IDS[i]
        parts.append(jtf.sample_plane(mats[i], xn[:, m0], xn[:, m1],
                                      align_corners)
                     * jtf.sample_line(vecs[i], xn[:, jtf.VEC_IDS[i]],
                                       align_corners))
    if not reduce:
        return jnp.concatenate(parts, axis=0)
    return sum(p.sum(0) for p in parts)


def close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("align_corners", [True, False])
def test_plain_matches_jax_with_vjps(jtf, align_corners, reduce):
    import jax
    import jax.numpy as jnp

    mats, vecs = factors((9, 11, 13), (3, 2, 5), seed=1)
    xn = mixed_points(300, seed=2)
    n_feat = 10
    ct = np.random.default_rng(3).normal(
        size=(n_feat, len(xn)) if not reduce else len(xn)).astype(np.float32)

    def jfn(*args):
        return jax_features(jtf, args[:3], args[3:6], args[6],
                            align_corners, reduce)

    jo, jvjp = jax.vjp(jfn, *map(jnp.asarray, mats + vecs + [xn]))
    jg = jvjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in mats + vecs + [xn]]
    to = vm.vm_features_plain(leaves[:3], leaves[3:6], leaves[6],
                              align_corners, reduce)
    tg = torch.autograd.grad(to, leaves, torch.from_numpy(ct))
    close(to.detach().numpy(), jo, 1e-5 if reduce else 1e-6, "features")
    # outside the box every feature is exactly zero
    out = (np.abs(xn) > 1).any(-1)
    assert out.any() and (to.detach().numpy()[..., out] == 0).all()
    names = [f"mat {i}" for i in range(3)] + [f"vec {i}" for i in range(3)]
    for g, want, what in zip(tg, jg, names + ["xn"]):
        close(g.numpy(), want, 1e-5, f"VJP of {what}")
    # the ties: zero outside, and at +-1 half (align_corners) or zero (+-1
    # lies half a cell past the clip's tie)
    dx = tg[6].numpy()
    assert (dx[8] == 0).all()
    assert (np.abs(dx[[0, 1, 2, 3, 4, 5], [0, 0, 1, 1, 2, 2]]) > 0).all() \
        == align_corners


def test_vm_features_on_the_cpu_is_the_plain_path():
    mats, vecs = factors((6, 7, 8), (4, 6, 5), seed=4)
    xn = torch.from_numpy(mixed_points(100, seed=5))
    mats, vecs = [torch.from_numpy(m) for m in mats], [torch.from_numpy(v)
                                                       for v in vecs]
    launches = (vm.vm_features.launches, vm.vm_features_bwd.launches)
    before = {k: dict(getattr(ttf, k)) for k in KINDS}
    for reduce in (True, False):
        assert torch.equal(vm.vm_features(mats, vecs, xn, True, reduce),
                           vm.vm_features_plain(mats, vecs, xn, True, reduce))
    assert (vm.vm_features.launches, vm.vm_features_bwd.launches) == launches
    # four calls of three pairs, 15 ranks in all, 164 points
    delta = {k: {kind: getattr(ttf, k)[kind] - before[k][kind]
                 for kind in ("plane", "line")} for k in KINDS}
    assert delta["lookup_rows"] == {"plane": 4 * 15 * 164,
                                    "line": 4 * 15 * 164}
    assert delta["lookup_points"] == {"plane": 12 * 164, "line": 12 * 164}


@pytest.mark.parametrize("r", [1, 4, 6, 16])
def test_cell_rows_lay_ranks_out_by_cell(r):
    f = torch.randn(r, 3, 5)
    rows = vm._cell_rows(f)
    r4 = -(-r // 4) * 4
    assert rows.shape == (15, r4) and rows.is_contiguous()
    assert torch.equal(rows[:, :r], f.reshape(r, 15).T)
    assert not rows[:, r:].any()


@pytest.mark.parametrize("case", ["rank", "size", "dtype", "count", "wide"])
def test_the_kernel_path_refuses_what_it_does_not_take(case):
    mats, vecs = factors((6, 7, 8), (4, 6, 5), seed=6)
    mats = [torch.from_numpy(m) for m in mats]
    vecs = [torch.from_numpy(v) for v in vecs]
    xn = torch.zeros(5, 3)
    if case == "rank":
        vecs[1] = vecs[1][:5]
    elif case == "size":
        mats[2] = mats[2][:, :1]
    elif case == "dtype":
        xn = xn.double()
    elif case == "count":
        mats = mats[:2]
    else:
        mats = [torch.zeros(400, 2, 2)] * 3
        vecs = [torch.zeros(400, 2)] * 3
    with pytest.raises(ValueError):
        vm._check(mats, vecs, xn)


# ------------------------------------------------------------- on the card

def card_run(mats, vecs, xn, align_corners, reduce, ct, fn, dx=True):
    """(features, cotangents of the six factors and of xn) of fn on the
    card."""
    leaves = [t.clone().requires_grad_(True) for t in mats + vecs]
    x = xn.clone().requires_grad_(dx)
    out = fn(leaves[:3], leaves[3:], x, align_corners, reduce)
    grads = torch.autograd.grad(out, leaves + ([x] if dx else []), ct)
    torch.cuda.synchronize()
    return out.detach(), grads


def check_against_plain(mats, vecs, xn, align_corners, what, dx=True):
    """The kernel against the plain path on the card: features, then each
    factor cotangent element within 1e-4 of the sum of its terms'
    magnitudes (the plain path's cotangent of |factors| under |cotangent|,
    with the same corners and weights), and xn's within 1e-5 of its
    largest entry."""
    names = [f"mat {i}" for i in range(3)] + [f"vec {i}" for i in range(3)]
    for reduce in (True, False):
        n_feat = sum(m.shape[0] for m in mats)
        gen = torch.Generator(xn.device).manual_seed(7)
        ct = torch.randn((xn.shape[0],) if reduce else (n_feat, xn.shape[0]),
                         generator=gen, device=xn.device)
        got, g_got = card_run(mats, vecs, xn, align_corners, reduce, ct,
                              vm.vm_features, dx)
        want, g_want = card_run(mats, vecs, xn, align_corners, reduce, ct,
                                vm.vm_features_plain, dx)
        _, g_abs = card_run([m.abs() for m in mats], [v.abs() for v in vecs],
                            xn, align_corners, reduce, ct.abs(),
                            vm.vm_features_plain, False)
        close(got.cpu(), want.cpu(), 1e-5 if reduce else 1e-6,
              f"{what} reduce={reduce}: features")
        for a, b, mag, name in zip(g_got, g_want, g_abs, names):
            off = (a - b).abs()
            bad = int((off > 1e-4 * mag).sum())
            worst = float((off / mag.clamp(min=1e-30)).max())
            assert bad == 0, (f"{what} reduce={reduce}: cotangent of {name}: "
                              f"{bad} elements off by more than 1e-4 of "
                              f"their terms' magnitudes (worst {worst:.3e})")
        if dx:
            close(g_got[6].cpu(), g_want[6].cpu(), 1e-5,
                  f"{what} reduce={reduce}: cotangent of xn")


@pytest.mark.cuda
@pytest.mark.parametrize("align_corners", [True, False])
def test_kernel_matches_plain_on_a_shell_batch(cuda_device, align_corners):
    """A pretraining batch at the published widths: 2^19 grid-ordered shell
    points, 42% of them padding that repeats row 0."""
    dev = cuda_device
    xn = torch.from_numpy(shell_batch(2**19, seed=8)).to(dev)
    for ranks in ((16, 16, 16), (48, 48, 48)):
        mats, vecs = factors((300, 300, 300), ranks, seed=9)
        check_against_plain([torch.from_numpy(m).to(dev) for m in mats],
                            [torch.from_numpy(v).to(dev) for v in vecs],
                            xn, align_corners, f"shells ranks {ranks}")


@pytest.mark.cuda
@pytest.mark.parametrize("align_corners", [True, False])
def test_kernel_matches_plain_on_random_points(cuda_device, align_corners):
    dev = cuda_device
    xn = torch.from_numpy(mixed_points(2**16, seed=10)).to(dev)
    mats, vecs = factors((300, 300, 300), (16, 16, 16), seed=11)
    mats = [torch.from_numpy(m).to(dev) for m in mats]
    vecs = [torch.from_numpy(v).to(dev) for v in vecs]
    check_against_plain(mats, vecs, xn, align_corners, "random points")
    check_against_plain(mats, vecs, xn, align_corners,
                        "random points, no xn cotangent", dx=False)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [(6, 6, 6), (5, 1, 7)])
def test_kernel_takes_ranks_not_a_multiple_of_4(cuda_device, ranks):
    dev = cuda_device
    xn = torch.from_numpy(mixed_points(2**14, seed=12)).to(dev)
    mats, vecs = factors((37, 2, 23), ranks, seed=13)
    for align in (True, False):
        check_against_plain([torch.from_numpy(m).to(dev) for m in mats],
                            [torch.from_numpy(v).to(dev) for v in vecs],
                            xn, align, f"ranks {ranks}")


@pytest.mark.cuda
def test_launches_and_counters_move_as_the_functions_do(cuda_device):
    dev = cuda_device
    xn = torch.from_numpy(shell_batch(2**16, seed=14)).to(dev)
    mats, vecs = factors((300, 300, 300), (16, 16, 16), seed=15)
    mats = [torch.from_numpy(m).to(dev) for m in mats]
    vecs = [torch.from_numpy(v).to(dev) for v in vecs]
    comps0 = int(vm._comps_counter(xn.device))
    deltas = []
    for fn in (vm.vm_features_plain, vm.vm_features):
        before = {k: dict(getattr(ttf, k)) for k in KINDS}
        launches = (vm.vm_features.launches, vm.vm_features_bwd.launches)
        for reduce in (True, False):
            out = fn(mats, vecs, xn, True, reduce)     # a teacher's query
            leaves = [t.clone().requires_grad_(True) for t in mats + vecs]
            out = fn(leaves[:3], leaves[3:], xn, True, reduce)
            torch.autograd.grad(out.sum(), leaves)
        deltas.append({k: {kind: getattr(ttf, k)[kind] - before[k][kind]
                           for kind in ("plane", "line")} for k in KINDS})
        ran = (vm.vm_features.launches - launches[0],
               vm.vm_features_bwd.launches - launches[1])
        assert ran == ((0, 0) if fn is vm.vm_features_plain else (4, 2))
    assert deltas[0] == deltas[1]
    assert deltas[1]["scatter_rows"] == {"plane": 2 * 3 * 16 * 2**16,
                                         "line": 2 * 3 * 16 * 2**16}
    # the merged atomics: some sent, fewer than one a corner row
    torch.cuda.synchronize()
    sent = int(vm._comps_counter(xn.device)) - comps0
    rows = deltas[1]["scatter_rows"]
    assert 0 < sent < 4 * rows["plane"] + 2 * rows["line"]


@pytest.mark.cuda
def test_kernel_path_refuses_on_the_card(cuda_device):
    dev = cuda_device
    mats, vecs = factors((8, 8, 8), (4, 4, 4), seed=16)
    mats = [torch.from_numpy(m).to(dev) for m in mats]
    vecs = [torch.from_numpy(v).to(dev) for v in vecs]
    with pytest.raises(ValueError):
        vm.vm_features(mats, vecs, torch.zeros(4, 3, dtype=torch.float64,
                                                device=dev))
    with pytest.raises(ValueError):
        vm.vm_features([m.cpu() for m in mats], vecs,
                       torch.zeros(4, 3, device=dev))
