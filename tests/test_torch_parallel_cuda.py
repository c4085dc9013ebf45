"""The multi-rank layer on the card, at a small size: parts (a) and (c) of
chip_smoke.py's phase 25.

Imports torch and the port only (no JAX), so it runs on a GPU machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Without a CUDA device the tests skip (K1 has no CPU or interpret mode).
- NCCL at world size 1: 4 steps through the collective code against the
  same steps without a mesh in this process: loss 1e-5 relative; the
  first step's reduced gradients within 1e-3 relative (L2 over all
  leaves; a run without the mesh in the rank's process reads ~2e-5); the
  params' mean |diff| after the steps within 0.3% of their mean |change|
  (chip_smoke's PAR_PARAM_SHARE; measured 1.0e-6 here);
- dp2 x tp2 over gloo, four ranks on the card: the level-sharded encode
  (K1 over each rank's levels) against K1 unsharded on the same rows,
  features 1e-5 and each shard's table gradient 1e-5 of the largest
  entry; no table-sized collective over 'model'.
"""

import dataclasses

import numpy as np
import pytest
import torch

from seal3d_tpu_torch.data.synthetic import SyntheticScene
from seal3d_tpu_torch.models.ngp import NGPConfig
from seal3d_tpu_torch.ops.halo_encode import halo_encode
from seal3d_tpu_torch.ops.hashgrid import HashGridConfig
from seal3d_tpu_torch.parallel import programs
from seal3d_tpu_torch.parallel.launch import launch
from seal3d_tpu_torch.parallel.mesh import find_table_collectives
from seal3d_tpu_torch.render.renderer import RenderOptions
from seal3d_tpu_torch.train.trainer import TrainConfig

TIMEOUT = 180.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU or interpret mode)")
    from seal3d_tpu_torch.runtime.build import build_library

    build_library()     # here, so that the ranks do not race to build it
    return torch.device("cuda")


@pytest.mark.cuda
def test_nccl_world1_matches_no_mesh(cuda_device):
    ds = SyntheticScene().make_dataset(n_views=4, h=32, w=32, seed=0,
                                       device=cuda_device)
    spec = {"fcfg": NGPConfig(bound=1.0, log2_hashmap_size=12,
                              grid_backend="halo", gridtype="wrap"),
            "opts": RenderOptions(bound=1.0, max_steps=512, budget_per_ray=48,
                                  num_candidates=256, min_near=0.05,
                                  coarse_steps=64, flat_frac=0.5),
            "tcfg": TrainConfig(num_rays=1024, random_bg=False),
            "dataset": ds, "grid_first": True, "steps": 4}
    ref = programs.train_rank(cuda_device, spec)
    ((ref2, r),) = launch(programs.run_all, 1, args=(
        [(programs.train_rank, spec),
         (programs.train_rank, dict(spec, mesh=(1,)))],),
        backend="nccl", device="cuda", timeout=TIMEOUT)
    np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)

    def rel_l2(a, b):
        return np.linalg.norm(np.concatenate([(a[k] - v).ravel() for k, v
                                              in b.items()])) / np.linalg.norm(
            np.concatenate([v.ravel() for v in b.values()]))

    def mean_diff(a, b):
        return np.mean(np.concatenate([np.abs(a[k] - v).ravel()
                                       for k, v in b.items()]))

    # two runs without the mesh differ, the more so in two processes
    # (atomic sums in K1's and the composite's backwards, bf16 rounding
    # after them, Adam's full step on a noise gradient): a run without the
    # mesh in the rank's process shows that floor (~2e-5 on the first
    # step's gradients); a wrong reduction is O(1) off
    floor = rel_l2(ref2["grads"], ref["grads"])
    assert rel_l2(r["grads"], ref["grads"]) <= 1e-3, floor
    share = mean_diff(r["params"], ref["params"]) / ref["moved"]
    print(f"[world 1] first step's gradients rel L2 "
          f"{rel_l2(r['grads'], ref['grads']):.3e} (floor {floor:.3e}); "
          f"params mean |diff| / mean |change| {share:.3e}")
    assert share <= 0.003
    assert [c.what for c in r["log"]] == ["grads"]


@pytest.mark.cuda
def test_tp_halo_ranks_match_k1(cuda_device):
    cfg = HashGridConfig(num_levels=16, log2_hashmap_size=15,
                         gridtype="wrap", backend="halo", shard_levels=True)
    rng = np.random.default_rng(5)
    m, t_rows = 4096, 2**15
    spec = {"cfg": cfg, "mesh": (2, 2),
            "table": rng.uniform(-1, 1, (16 * t_rows, 4)).astype(np.float32),
            "x": rng.uniform(0, 1, (m, 3)).astype(np.float32),
            "valid": rng.uniform(size=m) >= 0.25,
            "g": rng.uniform(-1, 1, (m, 64)).astype(np.float32)}
    ranks = launch(programs.encode_rank, 4, args=(spec,), backend="gloo",
                   device="cuda", timeout=TIMEOUT)
    whole = torch.from_numpy(spec["table"]).to(cuda_device).requires_grad_()
    out = halo_encode(whole, torch.from_numpy(spec["x"]).to(cuda_device),
                      torch.from_numpy(spec["valid"]).to(cuda_device),
                      dataclasses.replace(cfg, shard_levels=False))
    out = out.reshape(m, -1)
    out.backward(torch.from_numpy(spec["g"]).to(cuda_device))
    ref, grad = out.detach().cpu().numpy(), whole.grad.cpu().numpy()
    scale = float(np.abs(grad).max())
    for r in ranks:
        i, j = r["coords"]
        np.testing.assert_allclose(r["out"], ref[i * m // 2:(i + 1) * m // 2],
                                   atol=1e-5)
        np.testing.assert_allclose(
            r["grad"], grad[j * 8 * t_rows:(j + 1) * 8 * t_rows],
            atol=1e-5 * scale)
        assert not find_table_collectives(r["log"], 16 * t_rows, 2)
