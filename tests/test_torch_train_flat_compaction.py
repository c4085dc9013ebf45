"""Port parity of training under the legacy flat compaction
(`RenderOptions.compaction='flat'`): both packages train the same tiny NGP
field side by side on the same random numbers, as
tests/test_torch_train_parity.py does for the default march, for 96 steps
(tests/test_torch_tensorf_train.py's length) on the `halo` backend (the
reference's K1 replaced by its fp32 take-gather).

Under this compaction every step marches the legacy march (every candidate
tested, scatter-packed into N * budget_per_ray slots, no thinning), the
adaptive budget never retunes, and the evaluation renders through the same
march without a demand probe. Tolerances are that file's: the mean loss of
each 16-step block within 10%, val PSNR within 0.3 dB.
"""

import numpy as np
import pytest
import torch

import test_torch_train_parity as parity
from seal3d_tpu_torch.render import renderer
from test_torch_train_parity import (BLOCK, BLOCK_LOSS_RTOL, PSNR_TOL_DB,
                                     scene)  # noqa: F401
from test_torch_train_step import OPTS

STEPS = 96


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; PyTorch's default
    of one intra-op thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_flat_compaction_training_matches_jax(scene):  # noqa: F811
    legacy = []
    march_rays = renderer.march_rays

    def counted(*args, **kw):
        legacy.append(args[0].shape[0])
        return march_rays(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        # the side-by-side loop of test_torch_train_parity.py, with the
        # legacy compaction in both packages' options and 96 steps
        mp.setattr(parity, "OPTS", dict(OPTS, compaction="flat"))
        mp.setattr(parity, "STEPS", STEPS)
        mp.setattr(renderer, "march_rays", counted)
        jl, tl, jpsnr, tpsnr = parity._train_both(scene, "halo", mp)
    # every port step and every eval chunk marched the legacy march
    assert legacy.count(parity.NUM_RAYS) == STEPS and len(legacy) > STEPS
    jb = jl.reshape(-1, BLOCK).mean(1)
    tb = tl.reshape(-1, BLOCK).mean(1)
    print(f"\n[parity flat compaction] val PSNR reference {jpsnr:.3f} dB, "
          f"port {tpsnr:.3f} dB; block losses reference {np.round(jb, 5)}, "
          f"port {np.round(tb, 5)}")
    assert len(jl) == STEPS
    # the run trained (more slowly than the default march: 256 candidates
    # at dt_min without coarse tightening end short of the far side)
    assert jb[-1] < 0.8 * jb[0] and tb[-1] < 0.8 * tb[0], (jb, tb)
    np.testing.assert_allclose(tb, jb, rtol=BLOCK_LOSS_RTOL)
    assert abs(tpsnr - jpsnr) <= PSNR_TOL_DB, (jpsnr, tpsnr)
