"""Seeded inputs: sub-seeds and raw host batches.

The raw batches are those `gdl_tpu_torch/data/synthetic.py` makes (a
frozen copy, so a later change to the program cannot change the
traffic): {'wave' f32[B, N] (normal, 0.1), 'frames' u8[B, T, 256, 256,
3] (uniform), 'label' i32[B] (uniform over the classes)}, as a `Loader`
yields them. The same seed gives the same batches.
"""

from __future__ import annotations

import numpy as np

RAW_IMAGE_SIZE = 256  # the datasets' canonical frame canvas


def sub_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for one use of `seed` (weights, batches, ...)."""
    state = np.random.SeedSequence(int(seed), spawn_key=key).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def raw_batch(rng: np.random.Generator, batch: int, samples: int,
              frames: int, n_classes: int) -> dict:
    return {
        "wave": rng.standard_normal((batch, samples), dtype=np.float32)
        * np.float32(0.1),
        "frames": rng.integers(0, 256, (batch, frames, RAW_IMAGE_SIZE,
                                        RAW_IMAGE_SIZE, 3), dtype=np.uint8),
        "label": rng.integers(0, n_classes, (batch,)).astype(np.int32),
    }


def batch_pool(seed: int, count: int, batch: int, config: dict) -> list:
    """`count` distinct raw batches of `batch` clips for the
    configuration's dataset (its `audio` samples a clip, `frames` a clip,
    `n_classes`), drawn from `seed`."""
    audio = config["audio"]
    samples = audio["sample_rate"] * audio["seconds"]
    rng = np.random.default_rng(sub_seed(seed, 1))
    return [raw_batch(rng, batch, samples, config["frames"],
                      config["n_classes"]) for _ in range(count)]

