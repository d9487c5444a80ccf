"""Eval-time image preprocessing: Resize(224) + ToTensor + Normalize.

Port of the eval pieces of `gdl_tpu/ops/image_ops.py`. Frames stay
channel-last ([..., H, W, 3]) at the public functions, as in the
reference package.

`jax.image.resize` antialiases when it downsamples, so the 256→224 eval
resize here is `F.interpolate(bilinear, antialias=True)`; the
antialias=False variant differs by up to 55 on the 0-255 scale.
"""

from __future__ import annotations

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
