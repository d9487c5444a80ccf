"""Synthetic raw batches, port of `gdl_tpu/data/synthetic.py`.

Plain numpy seeded by `seed`, so the port and the reference package get
byte-identical raw requests from the same seed.
"""

from __future__ import annotations

import numpy as np

from gdl_tpu_torch.config import AUDIO_PARAMS, Config
from gdl_tpu_torch.data.datasets import RAW_IMAGE_SIZE


def synthetic_batch(cfg: Config, batch_size: int, n_frames: int = None,
                    seed: int = 0, raw_size: int = RAW_IMAGE_SIZE) -> dict:
    """{'wave' f32[B,N], 'frames' u8[B,T,R,R,3], 'label' i32[B]}."""
    rng = np.random.default_rng(seed)
    p = AUDIO_PARAMS[cfg.dataset]
    n = p["sample_rate"] * p["seconds"]
    t = n_frames if n_frames is not None else cfg.fps
    return {
        "wave": (rng.standard_normal((batch_size, n)) * 0.1).astype(
            np.float32),
        "frames": rng.integers(0, 256, (batch_size, t, raw_size, raw_size, 3),
                               dtype=np.uint8),
        "label": rng.integers(0, cfg.n_classes, (batch_size,)).astype(
            np.int32),
    }


class SyntheticDataset:
    """Dataset of per-sample tuples (wave, frames, label) matching
    _AVListDataset, each sample drawn from `seed + idx`."""

    def __init__(self, cfg: Config, size: int = 256, n_frames: int = None,
                 seed: int = 0):
        self.cfg = cfg
        self.size = size
        p = AUDIO_PARAMS[cfg.dataset]
        self.n = p["sample_rate"] * p["seconds"]
        self.t = n_frames if n_frames is not None else cfg.fps
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        wave = (rng.standard_normal(self.n) * 0.1).astype(np.float32)
        frames = rng.integers(
            0, 256, (self.t, RAW_IMAGE_SIZE, RAW_IMAGE_SIZE, 3),
            dtype=np.uint8)
        label = int(rng.integers(0, self.cfg.n_classes))
        return wave, frames, label
