"""On-device image preprocessing, port of `gdl_tpu/ops/image_ops.py`.

Eval: Resize(224) + ToTensor + Normalize. Train: torchvision's
RandomResizedCrop(224) + RandomHorizontalFlip + ToTensor + Normalize,
every frame with its own crop and flip. Frames stay channel-last
([..., H, W, 3]) at the public functions, as in the reference package.

`jax.image` antialiases when it downsamples. So the 256→224 eval resize
here is `F.interpolate(bilinear, antialias=True)` (antialias=False
differs by up to 55 on the 0-255 scale), and the train crop, whose box
may be larger than 224, is resampled with the weight matrices
`jax.image.scale_and_translate` builds: a triangle kernel, widened by
1/scale when downsampling, applied as one product per axis.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8/float [..., H, W, 3] → float32 ToTensor + Normalize."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x.float() / 255.0 - mean) / std


def resize_images(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Bilinear, antialiased resize of [..., H, W, 3] to size×size
    (float32 out, pixel scale unchanged)."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(lead + (size, size, c))


def eval_preprocess(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Test-time transform: Resize(size, size) + Normalize."""
    return normalize_images(resize_images(frames, size))


RRC_ATTEMPTS = 10
RRC_SCALE = (0.08, 1.0)
_MIN_RATIO, _MAX_RATIO = 3.0 / 4.0, 4.0 / 3.0


def sample_rrc_box(generator: Optional[torch.Generator], h: torch.Tensor,
                   w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """torchvision RandomResizedCrop.get_params for a batch of images of
    sizes (h [M], w [M]) → float (y0, x0, ch, cw), each [M] with integer
    values. Per image, 10 candidates are drawn at once: area
    U(0.08, 1)·h·w and a log-uniform aspect ratio in (3/4, 4/3), sizes
    rounded to integers; the first candidate that fits wins, at a uniform
    integer offset. If none fits, torchvision's fallback: the image's
    aspect ratio clamped into [3/4, 4/3], center-cropped."""
    h = h.float()
    w = w.float()
    m, dev = h.shape[0], h.device
    area = torch.empty((m, RRC_ATTEMPTS), device=dev).uniform_(
        *RRC_SCALE, generator=generator) * (h * w)[:, None]
    log_r = torch.empty((m, RRC_ATTEMPTS), device=dev).uniform_(
        math.log(_MIN_RATIO), math.log(_MAX_RATIO), generator=generator)
    ratio = torch.exp(log_r)
    cws = torch.round(torch.sqrt(area * ratio))
    chs = torch.round(torch.sqrt(area / ratio))
    valid = (cws > 0) & (cws <= w[:, None]) & (chs > 0) & (chs <= h[:, None])
    first = valid.int().argmax(dim=1, keepdim=True)  # first True (or 0)
    any_valid = valid.any(dim=1)

    in_ratio = w / h
    fb_w = torch.where(in_ratio > _MAX_RATIO, torch.round(h * _MAX_RATIO), w)
    fb_h = torch.where(in_ratio < _MIN_RATIO, torch.round(w / _MIN_RATIO), h)
    cw = torch.where(any_valid, cws.gather(1, first)[:, 0], fb_w)
    ch = torch.where(any_valid, chs.gather(1, first)[:, 0], fb_h)
    # torch.randint(0, H - h + 1): uniform over the inclusive range
    u = torch.rand((m, 2), generator=generator, device=dev)
    y0 = torch.where(any_valid, torch.floor(u[:, 0] * (h - ch + 1.0)),
                     torch.floor((h - ch) / 2.0))
    x0 = torch.where(any_valid, torch.floor(u[:, 1] * (w - cw + 1.0)),
                     torch.floor((w - cw) / 2.0))
    return y0, x0, ch, cw


def _resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """[M, out_size, in_size] bilinear weights of
    jax.image.scale_and_translate (antialias on) for per-image scale and
    translation [M]: output u samples input at (u + 0.5 - t)/s - 0.5
    with a triangle kernel widened by max(1/s, 1); columns normalised;
    samples outside the input get weight 0."""
    inv = 1.0 / scale[:, None, None]
    kernel_scale = torch.clamp(inv, min=1.0)
    u = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    sample = ((u[None, :, None] + 0.5) * inv
              - translation[:, None, None] * inv - 0.5)  # [M, out, 1]
    src = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    wts = torch.clamp(1.0 - (sample - src).abs() / kernel_scale, min=0.0)
    total = wts.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, wts, 0.0)


def crop_resize_flip(frames: torch.Tensor, boxes: torch.Tensor,
                     flips: torch.Tensor, size: int = 224,
                     orig_sizes: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Deterministic half of the train transform (gdl_tpu's `_rrc_one`):
    [B, T, H, W, 3] uint8/float frames, boxes [B, T, 4] float
    (y0, x0, ch, cw), flips [B, T] bool → [B, T, size, size, 3] float32
    cropped, resampled, flipped and normalized.

    Boxes are in canvas (H, W) coordinates, or, with orig_sizes
    ([B, T, 2]: each frame's original H, W), in original coordinates,
    mapped onto the canvas as gdl_tpu maps them."""
    b, t, h, w, c = frames.shape
    m = b * t
    y0, x0, ch, cw = boxes.reshape(m, 4).float().unbind(1)
    if orig_sizes is not None:
        osz = orig_sizes.reshape(m, 2).float().clamp(min=1.0)
        sy, sx = h / osz[:, 0], w / osz[:, 1]
        y0, ch, x0, cw = y0 * sy, ch * sy, x0 * sx, cw * sx
    wy = _resample_weights(h, size, size / ch, -y0 * size / ch)
    wx = _resample_weights(w, size, size / cw, -x0 * size / cw)
    img = frames.reshape(m, h, w, c).float()
    out = torch.einsum("moh,mhwc,mpw->mopc", wy, img, wx)
    flipped = torch.where(flips.reshape(m, 1, 1, 1).bool(),
                          out.flip(2), out)
    return normalize_images(flipped).reshape(b, t, size, size, c)


def random_resized_crop_flip(frames: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             size: int = 224,
                             orig_sizes: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """RandomResizedCrop(size) + RandomHorizontalFlip(0.5) + Normalize on
    [B, T, H, W, 3] frames, each frame its own draw from `generator`.
    orig_sizes ([B, T, 2]) draws the boxes against each frame's original
    size (torchvision's exact geometry); None draws on the canvas."""
    b, t, h, w, _ = frames.shape
    dev = frames.device
    if orig_sizes is None:
        hs = torch.full((b * t,), float(h), device=dev)
        ws = torch.full((b * t,), float(w), device=dev)
    else:
        osz = orig_sizes.reshape(b * t, 2).to(dev).float().clamp(min=1.0)
        hs, ws = osz[:, 0], osz[:, 1]
    boxes = torch.stack(sample_rrc_box(generator, hs, ws), dim=1)
    flips = torch.rand((b * t,), generator=generator, device=dev) < 0.5
    return crop_resize_flip(frames, boxes.reshape(b, t, 4),
                            flips.reshape(b, t), size, orig_sizes)
