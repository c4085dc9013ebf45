"""Port parity of the flat and dense compositors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal3d_tpu.ops import composite as jcomp
from seal3d_tpu_torch.ops import composite as tcomp


def _flat_buffer(seed, n=64, m=1500, sigma_scale=5.0):
    """A ray-contiguous flat buffer: ray r owns [offsets[r], offsets[r] +
    counts[r]); slots past the last segment are invalid tail."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, size=n)
    counts[rng.integers(0, n, size=5)] = 0       # rays with no samples
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    assert total < m
    ray_id = np.full(m, n - 1, np.int32)
    ray_id[:total] = np.repeat(np.arange(n), counts)
    valid = np.arange(m) < total
    sig = (rng.uniform(0, 1, m) * sigma_scale).astype(np.float32)
    rgb = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    deltas = rng.uniform(0.005, 0.02, m).astype(np.float32)
    ts = np.cumsum(deltas).astype(np.float32)
    return sig, rgb, deltas, ts, ray_id, offsets, valid, n


@pytest.mark.parametrize("seg_mode", ["scan", "scatter"])
@pytest.mark.parametrize("sigma_scale", [5.0, 2e4])
def test_composite_flat_matches_jax(seg_mode, sigma_scale):
    """Same mode in both packages: 1e-5 absolute. sigma ~1e4 (optical depth
    prefix ~1e5 over the buffer) pins the exact optical-depth scan: the
    reference's TwoSum-compensated f32 scan and the port's f64 prefix must
    agree where a plain f32 cumsum would lose the low bits."""
    sig, rgb, deltas, ts, ray_id, offsets, valid, n = _flat_buffer(
        0, sigma_scale=sigma_scale)
    j = jcomp.composite_flat(*map(jnp.asarray, (sig, rgb, deltas, ts, ray_id,
                                                offsets, valid)), n,
                             seg_mode=seg_mode)
    t = tcomp.composite_flat(*map(torch.from_numpy, (sig, rgb, deltas, ts,
                                                     ray_id.astype(np.int64),
                                                     offsets.astype(np.int64),
                                                     valid)), n,
                             seg_mode=seg_mode)
    for k in ("weights", "weights_sum", "depth", "image"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5,
                                   err_msg=k)


def test_composite_flat_optical_depth_has_no_prefix_loss():
    """With a huge optical-depth prefix ahead of it, a ray's weights equal
    those of the same ray composited alone (1e-6): the prefix difference is
    exact in the port."""
    sig, rgb, deltas, ts, ray_id, offsets, valid, n = _flat_buffer(
        1, sigma_scale=2e4)
    t = tcomp.composite_flat(*map(torch.from_numpy, (sig, rgb, deltas, ts,
                                                     ray_id.astype(np.int64),
                                                     offsets.astype(np.int64),
                                                     valid)), n)
    r = int(np.argmax(np.bincount(ray_id[valid], minlength=n)))
    seg = slice(offsets[r], offsets[r] + int((ray_id[valid] == r).sum()))
    sd = torch.from_numpy(sig[seg] * deltas[seg]).double()
    tau = torch.cumsum(sd, 0) - sd
    w = (torch.exp(-tau) * (1 - torch.exp(-sd))).float()
    np.testing.assert_allclose(t["weights"][seg].numpy(), w.numpy(), atol=1e-6)


def test_composite_dense_matches_jax():
    rng = np.random.default_rng(2)
    sig = rng.uniform(0, 30, (50, 40)).astype(np.float32)
    rgb = rng.uniform(0, 1, (50, 40, 3)).astype(np.float32)
    deltas = np.full((50, 40), 0.02, np.float32)
    ts = np.cumsum(deltas, 1)
    j = jcomp.composite_dense(*map(jnp.asarray, (sig, rgb, deltas, ts)))
    t = tcomp.composite_dense(*map(torch.from_numpy, (sig, rgb, deltas, ts)))
    for k in ("weights", "weights_sum", "depth", "image"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-5)
