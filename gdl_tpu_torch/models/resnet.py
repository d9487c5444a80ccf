"""Dual-stem ResNet encoders, port of `gdl_tpu/models/resnet.py`.

Capability parity with reference models/backbone.py: torchvision-style
ResNet-18 with a modality-specific stem — audio Conv(1→64, 7x7, s2),
visual Conv(3→64, 7x7, s2) (backbone.py:96-103) — returning the layer-4
feature map with no avgpool/fc (backbone.py:158-201). The visual forward
folds time into batch: [B, T, H, W, C] → [B*T, H, W, C].

Layout. The public inputs and the returned map are channel-last like
gdl_tpu's (audio [B, F, T, 1], visual [B, T, H, W, 3], map
[N, H/32, W/32, 8·width]). Inside, tensors are NCHW; on a CUDA device
they are kept in `channels_last` memory, so the permutes at both ends
are views and cuDNN and the max-pool kernel see C innermost. On the CPU
they take the default (contiguous) format: the memory format is a choice
of speed for the card, and PyTorch's CPU convolutions are best tested in
their default format.

Module names are the reference's (`conv1`, `bn1`, `layer{S}.{B}.conv1`,
`downsample.0/1`), so a reference state dict loads with strict=True.

gdl_tpu's `stem_mode='s2d'` (a space-to-depth lowering of the stem conv
for the TPU's matrix unit, off by default there) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gdl_tpu_torch.models.layers import batch_norm, conv, max_pool_3x3_s2


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity/projection shortcut
    (backbone.py:31-68)."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 bn_groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = conv(in_channels, filters, 3, stride, generator)
        self.bn1 = batch_norm(filters, bn_groups)
        self.conv2 = conv(filters, filters, 3, 1, generator)
        self.bn2 = batch_norm(filters, bn_groups)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(
                conv(in_channels, filters, 1, stride, generator),
                batch_norm(filters, bn_groups))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Feature-map encoder: stem + 4 stages, returns [N, H/32, W/32, 8w].

    modality='audio' expects [B, F, T, 1] log-spectrograms; 'visual'
    expects [B, T, H, W, 3] frame stacks and folds T into the batch
    dimension. pool_impl is the stem max-pool's `impl` ("auto": the CUDA
    backward kernel on the card; "plain": its plain version)."""

    def __init__(self, modality: str, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64, bn_groups: int = 1, pool_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if modality not in ("audio", "visual"):
            raise NotImplementedError(
                "Incorrect modality, should be audio or visual but got "
                + str(modality))
        self.modality = modality
        self.pool_impl = pool_impl
        in_channels = 1 if modality == "audio" else 3
        self.conv1 = conv(in_channels, width, 7, 2, generator)
        self.bn1 = batch_norm(width, bn_groups)
        channels = width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(BasicBlock(channels, filters, stride, bn_groups,
                                         generator))
                channels = filters
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)

    def forward(self, x):
        if self.modality == "visual":
            if x.dim() != 5:
                raise ValueError("visual input must be [B, T, H, W, C], got "
                                 "%s" % (tuple(x.shape),))
            b, t, h, w, c = x.shape
            x = x.reshape(b * t, h, w, c)
        # NHWC values → NCHW tensor; on the card in channels_last memory
        # (then the permute is a view)
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=(torch.channels_last if x.is_cuda
                           else torch.contiguous_format))
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2(x, self.pool_impl)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.permute(0, 2, 3, 1)


def resnet18(modality: str, width: int = 64,
             stage_sizes: Optional[Sequence[int]] = None, bn_groups: int = 1,
             pool_impl: str = "auto",
             generator: Optional[torch.Generator] = None) -> ResNet:
    """backbone.py:255-257."""
    return ResNet(modality, tuple(stage_sizes or (2, 2, 2, 2)), width,
                  bn_groups, pool_impl, generator)


def resnet50(modality: str, width: int = 64, pool_impl: str = "auto",
             generator: Optional[torch.Generator] = None) -> ResNet:
    """backbone.py:260-262: BasicBlock [3, 4, 6, 3], mislabeled in the
    reference and kept so (`gdl_tpu/models/resnet.py:174`)."""
    return ResNet(modality, (3, 4, 6, 3), width, 1, pool_impl, generator)
