"""Batch preprocessing on the device, port of `gdl_tpu/data/preprocess.py`.

A raw batch {'wave' f32[B,N], 'frames' u8[B,T,R,R,3], 'label' i32[B]}
(numpy arrays or tensors; optionally 'frame_sizes' i32[B,T,2], each
frame's original H, W) is copied to `device` as it is — uint8 frames
and the f32 waveform — and becomes {'audio' [B,F,T,1], 'visual'
[B,T,224,224,3], 'label' [B]} there: the log-STFT, then Resize +
Normalize at eval, RandomResizedCrop + flip + Normalize at train. Under
`--strict_compat` the datasets ship frames ALREADY cropped and flipped
to 224² on the host at original resolution (the reference's exact
single-resample pixels), marked by a 'host_exact' key in the batch; only
Normalize then runs on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.ops.image_ops import (
    eval_preprocess,
    normalize_images,
    random_resized_crop_flip,
)
from gdl_tpu_torch.ops.stft import spectrogram_for_dataset


def _host_exact(cfg: Config, batch, frames: torch.Tensor,
                image_size: int) -> bool:
    """True where the batch really carries host-transformed pixels: the
    explicit marker, never a shape coincidence (synthetic and canvas
    batches of any size still take the device transform)."""
    if not (getattr(cfg, "strict_compat", False) and "host_exact" in batch):
        return False
    assert frames.shape[-2] == image_size, \
        "host_exact batch is not image_size²"
    return True


def make_train_preprocess(cfg: Config, device, image_size: int = 224):
    """preprocess(batch, generator) with the eval spectrogram path and
    the train augmentation, its draws from `generator` (on `device`)."""
    swin = cfg.backbone == "swin"
    dataset = cfg.dataset
    device = torch.device(device)

    def preprocess(batch, generator: Optional[torch.Generator] = None):
        wave = torch.as_tensor(batch["wave"]).to(device)
        frames = torch.as_tensor(batch["frames"]).to(device)
        if _host_exact(cfg, batch, frames, image_size):
            visual = normalize_images(frames)
        else:
            sizes = batch.get("frame_sizes")
            if sizes is not None:
                sizes = torch.as_tensor(sizes).to(device)
            visual = random_resized_crop_flip(
                frames, generator, size=image_size, orig_sizes=sizes)
        return {"audio": spectrogram_for_dataset(wave, dataset, swin=swin),
                "visual": visual,
                "label": torch.as_tensor(batch["label"]).to(device)}

    return preprocess


def make_eval_preprocess(cfg: Config, device, image_size: int = 224):
    swin = cfg.backbone == "swin"
    dataset = cfg.dataset
    device = torch.device(device)

    def preprocess(batch):
        wave = torch.as_tensor(batch["wave"]).to(device)
        frames = torch.as_tensor(batch["frames"]).to(device)
        if _host_exact(cfg, batch, frames, image_size):
            visual = normalize_images(frames)
        else:
            visual = eval_preprocess(frames, size=image_size)
        return {"audio": spectrogram_for_dataset(wave, dataset, swin=swin),
                "visual": visual,
                "label": torch.as_tensor(batch["label"]).to(device)}

    return preprocess
