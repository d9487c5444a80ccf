"""SE-ResNet-18 building blocks for the intermediate-fusion family, port
of `gdl_tpu/models/se_resnet.py`: ResNet-18 with a 3x3/stride-2 stem
(resnet18_se.py:143), an SELayer after layer2 (:10-25, :217), and a
(layer3, layer4, avgpool, fc) trunk whose layer3 input width is given
(`SETrunk.in_channels`), so every consumer is well-formed.

Layout as in `models/resnet.py`: the public inputs and outputs are
channel-last like gdl_tpu's ([B, H, W, C]); inside, tensors are NCHW, in
`channels_last` memory on a CUDA device, so the permutes at both ends
are views. The stem's max-pool is `models.layers.max_pool_3x3_s2`, whose
backward on the card is the hand-written kernel (`ops/maxpool.py`).
Module names are gdl_tpu's (`conv1`, `bn1`, `layer{S}_{B}` →
`layer{S}.{B}`, `se.fc1`, `fc`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gdl_tpu_torch.models.layers import (
    batch_norm,
    conv,
    max_pool_3x3_s2,
    xavier_linear,
)
from gdl_tpu_torch.models.resnet import BasicBlock


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC values → NCHW tensor; on the card in channels_last memory
    (a view where x is already the NHWC view of such a tensor)."""
    return x.permute(0, 3, 1, 2).contiguous(
        memory_format=(torch.channels_last if x.is_cuda
                       else torch.contiguous_format))


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _stage(in_channels: int, filters: int, stride: int,
           generator: Optional[torch.Generator]) -> nn.Sequential:
    return nn.Sequential(
        BasicBlock(in_channels, filters, stride, generator=generator),
        BasicBlock(filters, filters, 1, generator=generator))


class SELayer(nn.Module):
    """Squeeze-and-excitation channel gate (resnet18_se.py:10-25), on an
    NCHW tensor."""

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = xavier_linear(channels, channels // reduction, generator)
        self.fc2 = xavier_linear(channels // reduction, channels, generator)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y[:, :, None, None].to(x.dtype)


class SEStem(nn.Module):
    """conv3x3/s2 + bn + relu + maxpool + layer1(64x2) + layer2(128x2)
    (+ optional SELayer, + optional 2x2 avg pool): the per-modality
    'special bone' (sefusion.py:28-42, surf_mmfomer.py:258-276).
    [B, H, W, 3] → [B, H/8 (/16 with use_avg), ·, 2·width]."""

    def __init__(self, use_se: bool = True, use_avg: bool = False,
                 width: int = 64, in_channels: int = 3,
                 pool_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_avg = use_avg
        self.pool_impl = pool_impl
        self.conv1 = conv(in_channels, width, 3, 2, generator)
        self.bn1 = batch_norm(width)
        self.layer1 = _stage(width, width, 1, generator)
        self.layer2 = _stage(width, 2 * width, 2, generator)
        self.se = SELayer(2 * width, generator=generator) if use_se else None

    def forward(self, x):
        x = to_nchw(x)
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2(x, self.pool_impl)
        x = self.layer2(self.layer1(x))
        if self.se is not None:
            x = self.se(x)
        if self.use_avg:
            x = F.avg_pool2d(x, 2, 2)
        return to_nhwc(x)


class SETrunk(nn.Module):
    """layer3(256x2) + layer4(512x2) + global avgpool + fc: the shared
    bone (sefusion.py:44-50). `in_channels` is the concat width feeding
    layer3. [B, h, w, in_channels] → logits (and the two maps)."""

    def __init__(self, num_classes: int, width: int = 64,
                 in_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_channels = 4 * width if in_channels is None else in_channels
        self.layer3 = _stage(in_channels, 4 * width, 2, generator)
        self.layer4 = _stage(4 * width, 8 * width, 2, generator)
        self.fc = xavier_linear(8 * width, num_classes, generator)

    def forward(self, x, return_maps: bool = False):
        layer3 = self.layer3(to_nchw(x))
        layer4 = self.layer4(layer3)
        logits = self.fc(layer4.mean(dim=(2, 3)))
        if return_maps:
            return logits, to_nhwc(layer3), to_nhwc(layer4)
        return logits
