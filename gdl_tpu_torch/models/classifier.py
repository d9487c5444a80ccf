"""Classifier assemblies, port of `gdl_tpu/models/classifier.py`.

Inputs are channel-last as in the reference package: audio
spectrograms [B, F, T, 1], visual frame stacks [B, T, H, W, 3].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.fusion import make_fusion
from gdl_tpu_torch.models.layers import (
    batch_norm,
    lecun_normal_,
    xavier_linear,
)
from gdl_tpu_torch.models.resnet import resnet18
from gdl_tpu_torch.models.swin import SwinTransformer


def lecun_conv(in_channels: int, features: int, kernel: int,
               generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """Conv2d with bias, padding kernel // 2 and flax nn.Conv's default
    init: lecun-normal weight (variance 1/fan_in, truncated at two
    standard deviations), zero bias."""
    layer = nn.Conv2d(in_channels, features, kernel, padding=kernel // 2)
    lecun_normal_(layer.weight, in_channels * kernel * kernel, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def pe_noise(shape, generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    """The standard-normal draw of the PE head's reparameterisation, f32
    [B, H, W, C] on `device` from the explicit generator."""
    src = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator, device=src,
                       dtype=torch.float32).to(device)


class PEHead(nn.Module):
    """Probabilistic-embedding (DUL) head: 1x1-conv+BN mu / logvar branches
    with a reparameterized sample in training mode, mu in eval mode
    (reference models/swin_transformer.py:574-583, :643-667).

    Input and outputs are NHWC feature maps; returns
    (sampled_map, mu, std). The noise comes from `generator`."""

    def __init__(self, features: int, in_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        in_channels = features if in_channels is None else in_channels
        self.mu_conv = lecun_conv(in_channels, features, 1, generator)
        self.mu_bn = batch_norm(features)
        self.logvar_conv = lecun_conv(in_channels, features, 1, generator)
        self.logvar_bn = batch_norm(features)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=(torch.channels_last if x.is_cuda
                           else torch.contiguous_format))
        mu = self.mu_bn(self.mu_conv(x)).permute(0, 2, 3, 1)
        logvar = self.logvar_bn(self.logvar_conv(x)).permute(0, 2, 3, 1)
        std = torch.exp(0.5 * logvar)
        if self.training:
            eps = pe_noise(std.shape, generator, std.device).to(std.dtype)
            out = mu + eps * std
        else:
            out = mu
        return out, mu, std


def _pool_audio(a_map: torch.Tensor) -> torch.Tensor:
    """adaptive_avg_pool2d(a, 1) + flatten over an NHWC map."""
    return a_map.mean(dim=(1, 2))


def _pool_visual(v_map: torch.Tensor, batch: int) -> torch.Tensor:
    """Unfold time from batch, adaptive_avg_pool3d + flatten."""
    bt, h, w, c = v_map.shape
    return v_map.reshape(batch, bt // batch, h, w, c).mean(dim=(1, 2, 3))


class AVClassifierDGL(nn.Module):
    """Dual ResNet-18 encoders + a DGL fusion head (basic_model.py:10-124).
    `forward(audio, visual)` returns the reference tuple order
    `(out, out_a, out_v)`; with cfg.modality "audio" or "visual" one
    encoder and a plain linear classifier give the same logits thrice.

    pool_impl="plain" runs the plain version of the stem max-pool's
    backward on any device (the reference the CUDA kernel is held to);
    "auto" takes the kernel on the card. The DGL train step uses
    `encode`, `unimodal_logits` and `fused_logits`, gdl_tpu's protocol;
    `generator` in their signatures is unused (no stochastic layers) and
    keeps the Swin classifier's call shape."""

    def __init__(self, cfg: Config, pool_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.modality = cfg.modality
        kw = dict(width=cfg.encoder_width, stage_sizes=cfg.encoder_stages,
                  bn_groups=cfg.bn_groups, pool_impl=pool_impl,
                  generator=generator)
        n = cfg.n_classes
        if cfg.modality == "full":
            self.audio_net = resnet18("audio", **kw)
            self.visual_net = resnet18("visual", **kw)
            self.fusion_module = make_fusion(
                cfg.fusion_method, n, dgl=True, input_dim=cfg.encoder_dim,
                generator=generator)
        elif cfg.modality == "visual":
            self.visual_net = resnet18("visual", **kw)
            self.visual_classifier = xavier_linear(cfg.encoder_dim, n,
                                                   generator)
        elif cfg.modality == "audio":
            self.audio_net = resnet18("audio", **kw)
            self.audio_classifier = xavier_linear(cfg.encoder_dim, n,
                                                  generator)
        else:
            raise ValueError(f"unknown modality {cfg.modality!r}")

    def encode(self, audio, visual,
               generator: Optional[torch.Generator] = None):
        """Pooled per-modality features (a [B, 8w], v [B, 8w])."""
        a_map = self.audio_net(audio)
        v_map = self.visual_net(visual)
        return _pool_audio(a_map), _pool_visual(v_map, audio.shape[0])

    def unimodal_logits(self, a, v):
        """(out_a, out_v) from live features through the fusion head with
        its parameters detached (gdl_tpu's stop_fusion_gradients)."""
        return self.fusion_module.unimodal(a, v, detach_params=True)

    def fused_logits(self, a, v):
        """The fused logits; the head detaches the features."""
        return self.fusion_module.fuse(a, v)

    def forward(self, audio, visual,
                generator: Optional[torch.Generator] = None):
        if self.modality == "full":
            a, v = self.encode(audio, visual)
            a_out, v_out, out = self.fusion_module(a, v)
            return out, a_out, v_out
        if self.modality == "visual":
            v = _pool_visual(self.visual_net(visual), visual.shape[0])
            out = self.visual_classifier(v)
        else:
            out = self.audio_classifier(_pool_audio(self.audio_net(audio)))
        return out, out, out


class AVClassifierSwinDGL(nn.Module):
    """Dual Swin encoders + a DGL fusion head. `forward(audio, visual)`
    returns `(out, out_a, out_v)`.

    attn_impl="plain" runs the window attention's plain PyTorch version
    on any device (the reference the CUDA kernels are held to); "auto"
    takes the kernels on the card. drop_path_rate is the encoders' (0.1
    in gdl_tpu). The DGL train step uses `encode`, `unimodal_logits` and
    `fused_logits`, gdl_tpu's protocol."""

    def __init__(self, cfg: Config, attn_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 drop_path_rate: float = 0.1):
        super().__init__()
        kw = dict(img_size=cfg.swin_img_size, patch_size=cfg.swin_patch,
                  embed_dim=cfg.swin_embed_dim, depths=tuple(cfg.swin_depths),
                  num_heads=tuple(cfg.swin_heads), window=cfg.swin_window,
                  attn_impl=attn_impl, drop_path_rate=drop_path_rate,
                  generator=generator)
        self.audio_net = SwinTransformer("audio", **kw)
        self.visual_net = SwinTransformer("visual", **kw)
        feat_dim = cfg.swin_embed_dim * 2 ** (len(cfg.swin_depths) - 1)
        self.fusion_module = make_fusion(cfg.fusion_method, cfg.n_classes,
                                         dgl=True, input_dim=feat_dim,
                                         generator=generator)

    def encode(self, audio, visual,
               generator: Optional[torch.Generator] = None):
        """Pooled features (a, v); `generator` feeds DropPath in training
        mode."""
        a_map = self.audio_net(audio, generator)
        v_map = self.visual_net(visual, generator)
        return _pool_audio(a_map), _pool_visual(v_map, audio.shape[0])

    def unimodal_logits(self, a, v):
        """(out_a, out_v) from live features through the fusion head with
        its parameters detached (gdl_tpu's stop_fusion_gradients)."""
        return self.fusion_module.unimodal(a, v, detach_params=True)

    def fused_logits(self, a, v):
        """The fused logits; the head detaches the features."""
        return self.fusion_module.fuse(a, v)

    def forward(self, audio, visual,
                generator: Optional[torch.Generator] = None):
        a, v = self.encode(audio, visual, generator)
        a_out, v_out, out = self.fusion_module(a, v)
        return out, a_out, v_out
