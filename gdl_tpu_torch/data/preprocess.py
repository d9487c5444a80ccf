"""Batch preprocessing on the device, port of `gdl_tpu/data/preprocess.py`.

A raw batch {'wave' f32[B,N], 'frames' u8[B,T,R,R,3], 'label' i32[B]}
(numpy arrays or tensors; optionally 'frame_sizes' i32[B,T,2], each
frame's original H, W) is copied to `device` as it is — uint8 frames
and the f32 waveform — and becomes {'audio' [B,F,T,1], 'visual'
[B,T,224,224,3], 'label' [B]} there: the log-STFT, then Resize +
Normalize at eval, RandomResizedCrop + flip + Normalize at train. The
`--strict_compat` host-exact frames of gdl_tpu come with the ported
datasets, not yet: such a batch raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.ops.image_ops import (
    eval_preprocess,
    random_resized_crop_flip,
)
from gdl_tpu_torch.ops.stft import spectrogram_for_dataset


def _host_exact(cfg: Config, batch) -> None:
    if getattr(cfg, "strict_compat", False) and "host_exact" in batch:
        raise NotImplementedError(
            "--strict_compat host-exact frames need the ported datasets")


def make_train_preprocess(cfg: Config, device, image_size: int = 224):
    """preprocess(batch, generator) with the eval spectrogram path and
    the train augmentation, its draws from `generator` (on `device`)."""
    swin = cfg.backbone == "swin"
    dataset = cfg.dataset
    device = torch.device(device)

    def preprocess(batch, generator: Optional[torch.Generator] = None):
        _host_exact(cfg, batch)
        wave = torch.as_tensor(batch["wave"]).to(device)
        frames = torch.as_tensor(batch["frames"]).to(device)
        sizes = batch.get("frame_sizes")
        if sizes is not None:
            sizes = torch.as_tensor(sizes).to(device)
        return {"audio": spectrogram_for_dataset(wave, dataset, swin=swin),
                "visual": random_resized_crop_flip(
                    frames, generator, size=image_size, orig_sizes=sizes),
                "label": torch.as_tensor(batch["label"]).to(device)}

    return preprocess


def make_eval_preprocess(cfg: Config, device, image_size: int = 224):
    swin = cfg.backbone == "swin"
    dataset = cfg.dataset
    device = torch.device(device)

    def preprocess(batch):
        wave = torch.as_tensor(batch["wave"]).to(device)
        frames = torch.as_tensor(batch["frames"]).to(device)
        return {"audio": spectrogram_for_dataset(wave, dataset, swin=swin),
                "visual": eval_preprocess(frames, size=image_size),
                "label": torch.as_tensor(batch["label"]).to(device)}

    return preprocess
