"""Eval batch preprocessing on the device, port of
`gdl_tpu/data/preprocess.py::make_eval_preprocess`.

A raw batch {'wave' f32[B,N], 'frames' u8[B,T,R,R,3], 'label' i32[B]}
(numpy arrays or tensors) is copied to `device` as it is — uint8 frames
and the f32 waveform — and becomes {'audio' [B,F,T,1], 'visual'
[B,T,224,224,3], 'label' [B]} there. The `--strict_compat` host-exact
frames of gdl_tpu come with the ported datasets, not yet.
"""

from __future__ import annotations

import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.ops.image_ops import eval_preprocess
from gdl_tpu_torch.ops.stft import spectrogram_for_dataset


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
