"""Deterministic seeding (port of seal3d_tpu/utils/seeding.py)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int):
    """Seed Python's and numpy's global generators and set PYTHONHASHSEED,
    as the JAX package does, and PyTorch's default generators (the CPU's
    and every card's), which the port's draws without an explicit
    generator take."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
