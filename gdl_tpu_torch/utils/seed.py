"""Deterministic seeding, port of `gdl_tpu/utils/seed.py` (reference
utils/utils.py:7-12 `setup_seed`).

Seeds numpy and python for the host-side pipeline (shuffling, file
sampling) and returns an explicit `torch.Generator` on `device`, from
which all device randomness (augmentation, DropPath) derives. torch's
global generators are left alone.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int, device="cpu") -> torch.Generator:
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
