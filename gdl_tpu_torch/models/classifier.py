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
from gdl_tpu_torch.models.swin import SwinTransformer


def _pool_audio(a_map: torch.Tensor) -> torch.Tensor:
    """adaptive_avg_pool2d(a, 1) + flatten over an NHWC map."""
    return a_map.mean(dim=(1, 2))


def _pool_visual(v_map: torch.Tensor, batch: int) -> torch.Tensor:
    """Unfold time from batch, adaptive_avg_pool3d + flatten."""
    bt, h, w, c = v_map.shape
    return v_map.reshape(batch, bt // batch, h, w, c).mean(dim=(1, 2, 3))


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
