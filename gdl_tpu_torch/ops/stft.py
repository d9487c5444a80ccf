"""Audio frontend: framing → periodic Hann window → rFFT → log-magnitude.

Port of `gdl_tpu/ops/stft.py`: librosa.stft(y, n_fft, hop_length) with its
pre-0.10 defaults (center=True, reflect padding, periodic Hann), then
log(|S| + 1e-7). Runs on whatever device the waveform is on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gdl_tpu_torch.config import AUDIO_PARAMS


@functools.lru_cache(maxsize=8)
def _hann(n_fft: int) -> np.ndarray:
    """Periodic Hann, computed in float64 and cast, as the reference is."""
    n = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(np.float32)


def log_stft(wave: torch.Tensor, n_fft: int, hop: int,
             eps: float = 1e-7) -> torch.Tensor:
    """[B, N] float waveform → [B, n_fft//2+1, 1 + N//hop] log-magnitude."""
    if wave.ndim != 2:
        raise ValueError("wave must be [B, N], got %s" % (tuple(wave.shape),))
    pad = n_fft // 2
    x = F.pad(wave.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    segs = x.unfold(-1, n_fft, hop)  # [B, frames, n_fft]
    window = torch.from_numpy(_hann(n_fft)).to(x.device)
    spec = torch.fft.rfft(segs * window, dim=-1)  # [B, frames, bins]
    out = torch.log(spec.abs() + eps)
    return out.transpose(1, 2)  # [B, bins, frames]


def np_resize_flat(x: torch.Tensor, shape) -> torch.Tensor:
    """Batched np.resize: flatten each sample, tile until the target
    element count is reached, truncate, reshape."""
    b = x.shape[0]
    flat = x.reshape(b, -1)
    target = int(np.prod(shape))
    reps = -(-target // flat.shape[1])
    flat = flat.repeat(1, reps)[:, :target]
    return flat.reshape((b,) + tuple(shape))


def spectrogram_for_dataset(wave: torch.Tensor, dataset: str,
                            swin: bool = False) -> torch.Tensor:
    """[B, N] waveform → [B, F, T, 1] log-spectrogram (channel-last, the
    reference package's layout). Swin runs, and AVE always, take the
    reference's flat `np.resize` wrap to 224x224, not an image resize."""
    p = AUDIO_PARAMS[dataset]
    spec = log_stft(wave, p["n_fft"], p["hop"])
    if swin or dataset == "AVE":
        spec = np_resize_flat(spec, (224, 224))
    return spec[..., None]
