"""Seal tool configs shared by the port's Seal tests (numpy only, no JAX,
so the `cuda` tests can take them on a machine without JAX): strokes on the
procedural scene's box top (y = -0.27) and on ball 1's cap, several strokes,
a collinear stroke, a `dry` stroke and two anchors; and seeded query points
around an edit."""

import numpy as np


def grid_stroke(x, z, y, n=9):
    """An n x n grid of stroke points on the plane y = const."""
    gx, gz = np.meshgrid(np.linspace(*x, n), np.linspace(*z, n))
    return np.stack([gx, np.full_like(gx, y), gz], -1).reshape(-1, 3)


def _cap(center, radius, aperture, n, seed):
    """n seeded points on a ball's cap around its +y pole."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(np.cos(aperture), 1.0, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    return np.asarray(center) + radius * np.stack(
        [np.sin(theta) * np.cos(phi), np.cos(theta),
         np.sin(theta) * np.sin(phi)], -1)


def _tilt(pts, angle=0.4):
    """Points rotated about the z axis by `angle`."""
    c, s = np.cos(angle), np.sin(angle)
    return pts @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])


def brush(raw, brush_type="line", **kw):
    """A brush config over stroke points `raw` (one stroke, or a list of
    strokes), normal +y, pressure 0.05, depth 1, linear attenuation over
    0.05; `kw` overrides."""
    raw = raw if isinstance(raw, list) else np.asarray(raw).tolist()
    cfg = {"type": "brush", "raw": raw,
           "normal": [0.0, 1.0, 0.0], "brushType": brush_type,
           "brushPressure": 0.05, "brushDepth": 1.0,
           "attenuationDistance": 0.05, "attenuationMode": "linear"}
    cfg.update(kw)
    return cfg


# the procedural scene's box top (y = -0.27) and ball 1's cap
BOX_TOP = grid_stroke((-0.35, -0.05), (-0.40, -0.15), -0.27)
CAP = _cap([0.35, 0.1, 0.0], 0.22, 0.6, 160, seed=0)
CONFIGS = {
    "line": brush(BOX_TOP),
    "line_tilted": brush(_tilt(grid_stroke((-0.2, 0.2), (-0.2, 0.2), 0.0,
                                            n=11)), brushPressure=0.08,
                         attenuationDistance=0.03),
    "curve": brush(CAP, "curve", simplifyVoxel=12),
    "strokes": brush([BOX_TOP.tolist(), CAP.tolist()], ["line", "curve"]),
    "strokes_one_type": brush(
        [BOX_TOP.tolist(),
         grid_stroke((0.1, 0.3), (0.1, 0.3), -0.27, n=5).tolist()], "line"),
    "collinear": brush(np.stack([np.linspace(-0.3, 0.3, 13),
                                 np.full(13, -0.27), np.zeros(13)], -1)),
    "dry": brush(BOX_TOP, attenuationMode="dry"),
    "anchor": {"type": "anchor", "raw": CAP[:8].tolist(),
               "translation": [0.0, 0.12, 0.0], "radius": 0.08},
    "anchor_scaled": {"type": "anchor",
                      "raw": grid_stroke((-0.2, 0.2), (-0.2, 0.2), 0.0,
                                          n=7).tolist(),
                      "translation": [0.05, 0.3, 0.0], "radius": 0.25,
                      "scale": [1.2, 1.0, 0.8]},
}


def points_around(m, rng, n=4096):
    """n seeded points in the edit's force-fill box grown by 0.05, half of
    them pulled onto the stroke's representatives (jittered), so the
    stroke's inside is well sampled."""
    lo = m.force_fill_bound[:, 0].min(0) - 0.05
    hi = m.force_fill_bound[:, 1].max(0) + 0.05
    pts = rng.uniform(lo, hi, (n, 3))
    key = next(k for k in ("reps", "v_anchor", "center") if k in m.data)
    anchors = np.asarray(m.data[key]).reshape(-1, 3)
    near = anchors[rng.integers(0, len(anchors), n // 2)]
    pts[: n // 2] = near + rng.normal(0, 0.04, (n // 2, 3))
    return pts.astype(np.float32)


def boundary_slack(m, pts):
    """Per point, the smallest float64 distance of the membership test's
    quantities to their thresholds (the map bound's faces and the tool's
    own comparisons); `m` is either package's mapper."""
    p = pts.astype(np.float64)
    d = {k: np.asarray(v, np.float64) for k, v in m.data.items()}
    b = d["map_bound"]
    s = np.abs(p[:, None, None, :] - b[None]).reshape(len(p), -1).min(1)
    if m.kind == "brush":
        if "curve" in m.flags:
            d2 = ((p[:, None] - d["reps"][None]) ** 2).sum(-1)
            j = d2.argmin(1)
            h = ((p - d["reps"][j]) * d["rep_normals"][j]).sum(-1)
            lat = np.sqrt(np.maximum(d2.min(1) - h * h, 0))
            lo, hi = -d["depth"] * d["pressure"], 2 * d["pressure"]
        else:
            ne = d["normal_expand"]
            nl = np.linalg.norm(ne) + 1e-12
            h = (p - d["plane_center"]) @ (ne / nl)
            proj = p - ((p - d["plane_center"]) @ ne / (ne @ ne))[:, None] * ne
            lat = np.sqrt(((proj[:, None] - d["reps"][None]) ** 2)
                          .sum(-1).min(1))
            lo, hi = -d["depth"] * nl, 2 * nl
        s = np.minimum(s, np.minimum(np.abs(h - lo), np.abs(h - hi)))
        s = np.minimum(s, np.abs(lat - d["lateral_margin"]))
    return s
