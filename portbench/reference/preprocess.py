"""Raw batch → model inputs, in plain PyTorch.

Audio: librosa's pre-0.10 `stft` (center, reflect padding, periodic
Hann) as `torch.stft`, then log(|S| + 1e-7); Swin takes the flat
`np.resize` wrap of the spectrogram to 224 x 224
(CramedDataset.py:163's rule).

Frames at eval: bilinear, antialiased resize to 224², ToTensor and
ImageNet Normalize. In training, torchvision's RandomResizedCrop(224)
(scale 0.08–1, ratio 3/4–4/3, ten attempts, centre fallback) and
RandomHorizontalFlip, each frame its own draw, resampled as
`jax.image.scale_and_translate` resamples (a triangle kernel widened by
the downscale factor), the gdl_tpu lineage's definition. The draws come
from the generator the caller passes, in the order the program's
definition makes them: the crop areas [M, 10], the log ratios [M, 10],
the offsets [M, 2], the flips [M], for the M = B·T frames of a batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SIZE = 224


def spectrogram(wave: torch.Tensor, audio: dict, swin: bool) -> torch.Tensor:
    """[B, N] waveform → [B, 1, F, T] log-magnitude spectrogram."""
    n_fft, hop = audio["n_fft"], audio["hop"]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                               device=wave.device).float()
    spec = torch.stft(wave.float(), n_fft, hop_length=hop, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    out = torch.log(spec.abs() + 1e-7)  # [B, bins, frames]
    if swin:  # np.resize: tile the flattened spectrogram, cut to 224²
        flat = out.reshape(out.shape[0], -1)
        need = SIZE * SIZE
        flat = flat.repeat(1, -(-need // flat.shape[1]))[:, :need]
        out = flat.reshape(-1, SIZE, SIZE)
    return out[:, None]


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[M, 3, H, W] on the 0–255 scale → ToTensor + Normalize."""
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


def eval_frames(frames: torch.Tensor) -> torch.Tensor:
    """u8 [B, T, H, W, 3] → f32 [B·T, 3, 224, 224]."""
    b, t, h, w, c = frames.shape
    x = frames.reshape(b * t, h, w, c).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(SIZE, SIZE), mode="bilinear",
                      align_corners=False, antialias=True)
    return normalize(x)


def crop_boxes(m: int, h: int, w: int, gen: torch.Generator, device):
    """torchvision's RandomResizedCrop.get_params for m frames of h × w:
    (top, left, height, width), each [m] float."""
    area = torch.empty((m, 10), device=device).uniform_(0.08, 1.0,
                                                        generator=gen)
    area = area * (h * w)
    log_ratio = torch.empty((m, 10), device=device).uniform_(
        math.log(3.0 / 4.0), math.log(4.0 / 3.0), generator=gen)
    ratio = torch.exp(log_ratio)
    cw = torch.round(torch.sqrt(area * ratio))
    ch = torch.round(torch.sqrt(area / ratio))
    fits = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    pick = fits.int().argmax(dim=1, keepdim=True)
    ok = fits.any(dim=1)
    u = torch.rand((m, 2), generator=gen, device=device)
    height = torch.where(ok, ch.gather(1, pick)[:, 0], float(h))
    width = torch.where(ok, cw.gather(1, pick)[:, 0], float(w))
    top = torch.where(ok, torch.floor(u[:, 0] * (h - height + 1.0)),
                      torch.floor((h - height) / 2.0))
    left = torch.where(ok, torch.floor(u[:, 1] * (w - width + 1.0)),
                       torch.floor((w - width) / 2.0))
    return top, left, height, width


def resample_matrix(start: torch.Tensor, length: torch.Tensor,
                    in_size: int) -> torch.Tensor:
    """[m, 224, in_size]: jax.image.scale_and_translate's weights for each
    frame's crop [start, start + length) at scale 224 / length and
    translation −start · scale: output pixel o samples the input at
    (o + 0.5) / scale − translation / scale − 0.5 through a triangle of
    half-width max(1 / scale, 1); weights normalised to sum 1, and 0
    where the sample lies outside the input."""
    inv = (1.0 / (SIZE / length))[:, None, None]
    translation = (-start * SIZE / length)[:, None, None]
    o = torch.arange(SIZE, device=start.device, dtype=torch.float32)
    pos = (o[None, :, None] + 0.5) * inv - translation * inv - 0.5
    src = torch.arange(in_size, device=start.device, dtype=torch.float32)
    width = torch.clamp(inv, min=1.0)
    wts = torch.clamp(1.0 - (pos - src).abs() / width, min=0.0)
    total = wts.sum(dim=2, keepdim=True)
    tiny = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > tiny,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= in_size - 0.5)
    return torch.where(inside, wts, 0.0)


def train_frames(frames: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """u8 [B, T, H, W, 3] → f32 [B·T, 3, 224, 224]: crop, resample, flip,
    normalize, with the draws from `gen`."""
    b, t, h, w, c = frames.shape
    m = b * t
    top, left, height, width = crop_boxes(m, h, w, gen, frames.device)
    flip = torch.rand((m,), generator=gen, device=frames.device) < 0.5
    rows = resample_matrix(top, height, h)  # [m, 224, H]
    cols = resample_matrix(left, width, w)  # [m, 224, W]
    x = frames.reshape(m, h, w, c).permute(0, 3, 1, 2).float()
    x = torch.matmul(rows[:, None], x)  # [m, 3, 224, W]
    x = torch.matmul(x, cols[:, None].transpose(-1, -2))  # [m, 3, 224, 224]
    x = torch.where(flip[:, None, None, None], x.flip(-1), x)
    return normalize(x)


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_inputs(batch: dict, config: dict, gen: torch.Generator):
    """(audio [B,1,F,T], visual [B·T,3,224,224], label [B]) of a raw batch
    on the device, with the training augmentation."""
    swin = config["model"] == "swin_dgl"
    audio = spectrogram(batch["wave"], config["audio"], swin)
    return audio, train_frames(batch["frames"], gen), batch["label"].long()


def eval_inputs(batch: dict, config: dict):
    swin = config["model"] == "swin_dgl"
    audio = spectrogram(batch["wave"], config["audio"], swin)
    return audio, eval_frames(batch["frames"]), batch["label"].long()
