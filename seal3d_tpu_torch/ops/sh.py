"""Real spherical-harmonics direction encoding (port of seal3d_tpu/ops/sh.py).

Degrees 1-4 are hard-coded with the instant-ngp / torch-ngp constants;
degrees 5-8 use the reference's generic scaled associated-Legendre
recurrence (differentiable, no division by sin(theta) at the poles).
"""

from __future__ import annotations

import math

import torch


def sh_encode_dim(degree: int) -> int:
    return degree * degree


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[..., 3] unit directions -> [..., degree**2] real SH basis values."""
    if not 1 <= degree <= 8:
        raise ValueError(f"sh_encode supports degrees 1-8, not {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    if degree > 4:
        return _sh_generic(x, y, z, degree)
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        comps += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree >= 4:
        comps += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(comps, dim=-1)


def _sh_generic(x, y, z, degree: int) -> torch.Tensor:
    """Real SH of any degree from the scaled Legendre functions P_l^m(z)
    (sin^m(theta) removed) and A_m = Re((x + iy)^m), B_m = Im((x + iy)^m),
    which carry the sin^m(theta) cos/sin(m phi) factors."""
    lmax = degree - 1
    a_m, b_m = [torch.ones_like(x), x], [torch.zeros_like(x), y]
    for m in range(2, lmax + 1):
        a_m.append(x * a_m[m - 1] - y * b_m[m - 1])
        b_m.append(x * b_m[m - 1] + y * a_m[m - 1])
    p = {(0, 0): torch.ones_like(z)}
    for m in range(1, lmax + 1):
        p[(m, m)] = (1.0 - 2.0 * m) * p[(m - 1, m - 1)]
    for m in range(0, lmax):
        p[(m + 1, m)] = (2.0 * m + 1.0) * z * p[(m, m)]
    for l in range(2, lmax + 1):
        for m in range(0, l - 1):
            p[(l, m)] = ((2.0 * l - 1.0) * z * p[(l - 1, m)]
                         - (l + m - 1.0) * p[(l - 2, m)]) / (l - m)

    def norm(l, m):
        return math.sqrt((2.0 * l + 1.0) / (4.0 * math.pi)
                         * math.factorial(l - m) / math.factorial(l + m))

    comps = []
    sqrt2 = math.sqrt(2.0)
    for l in range(0, lmax + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = norm(l, am)
            if m == 0:
                comps.append(k * p[(l, 0)])
            elif m > 0:
                comps.append(sqrt2 * k * p[(l, am)] * a_m[am])
            else:
                comps.append(sqrt2 * k * p[(l, am)] * b_m[am])
    return torch.stack(comps, dim=-1)
