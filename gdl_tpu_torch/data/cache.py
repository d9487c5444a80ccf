"""Writers for the offline-preprocessed cache (the files
`--preprocessed_path` consumes; format notes in tools/preprocess_dataset.py
which drives these over whole datasets).

Shared by the offline tool and the on-the-fly `--preprocessed_write` path
(datasets.__getitem__): writes are idempotent (existing files skipped) and
atomic (tmp + rename), so concurrent loader workers — or a tool run racing
a training run — converge on identical, complete entries.

Replaces nothing in the reference (it re-decodes every epoch in 32
DataLoader workers — SURVEY §3.5).
"""

from __future__ import annotations

import os

import numpy as np

from gdl_tpu_torch.config import AUDIO_PARAMS


def write_audio(path: str, dataset: str, out_file: str) -> None:
    """Cache one clip's audio: the RESAMPLED f32 waveform (the pure-Python
    load_wav numerics — the per-epoch tile/crop tail stays at load)."""
    if os.path.exists(out_file):
        return
    from gdl_tpu_torch.data.wav import load_wav

    sr = AUDIO_PARAMS[dataset]["sample_rate"]
    wave = load_wav(path, sr)
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    tmp = out_file + ".tmp.npy"
    np.save(tmp, wave.astype(np.float32))
    os.replace(tmp, out_file)


def write_frames(video_dir: str, out_file: str) -> None:
    """Cache one clip's frames: EVERY frame decoded to the canonical
    256^2 canvas as one C-order .npy (read back memory-mapped / row-
    preaded) plus a .names.npy sidecar with the sorted entry names so
    the per-epoch random frame selection draws the same indices as the
    live path, and a .sizes.npy sidecar with each frame's ORIGINAL
    (H, W) so the device draws RandomResizedCrop parameters in original
    coordinates (the torchvision-exact geometry; datasets._cached_sizes
    reads it back)."""
    if os.path.exists(out_file):
        return
    from gdl_tpu_torch.data.datasets import (
        RAW_IMAGE_SIZE,
        _decode_frame_with_size,
        listdir_nohidden,
    )

    entries = sorted(listdir_nohidden(video_dir))
    names = [os.path.basename(e) for e in entries]
    frames, sizes = [], []
    for e in entries:
        try:
            f, hw = _decode_frame_with_size(e)
            frames.append(f)
            sizes.append(hw)
        except Exception:
            # corrupt image -> black frame, matching the live loader
            # (_load_frames; dataset/KSDataset.py:182-187)
            frames.append(np.zeros((RAW_IMAGE_SIZE, RAW_IMAGE_SIZE, 3),
                                   np.uint8))
            sizes.append((RAW_IMAGE_SIZE, RAW_IMAGE_SIZE))
    if not frames:
        frames = [np.zeros((RAW_IMAGE_SIZE, RAW_IMAGE_SIZE, 3), np.uint8)]
        names = [""]
        sizes = [(RAW_IMAGE_SIZE, RAW_IMAGE_SIZE)]
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    # plain .npy (NOT npz): the zip layer costs time per clip and forces a
    # full read; .npy rows can be gathered individually. Names ride a
    # sidecar (unicode array — no pickle needed).
    tmp = out_file + ".tmp.npy"
    np.save(tmp, np.stack(frames))
    os.replace(tmp, out_file)
    tmp = out_file + ".names.tmp.npy"
    np.save(tmp, np.array(names))
    os.replace(tmp, out_file + ".names.npy")
    tmp = out_file + ".sizes.tmp.npy"
    np.save(tmp, np.asarray(sizes, np.int32))
    os.replace(tmp, out_file + ".sizes.npy")
