"""Classifier assemblies, port of `gdl_tpu/models/classifier.py`: the
DGL classifiers (AVClassifierDGL, AVClassifierSwinDGL) and the joint
lineage's (AVClassifier, AVClassifierSwin).

Inputs are channel-last as in the reference package: audio
spectrograms [B, F, T, 1], visual frame stacks [B, T, H, W, 3].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.fusion import ConcatFusionSwin, make_fusion
from gdl_tpu_torch.models.layers import (
    batch_norm,
    lecun_normal_,
    xavier_linear,
)
from gdl_tpu_torch.models.resnet import resnet18
from gdl_tpu_torch.models.swin import SwinTransformer
from gdl_tpu_torch.parallel.distributed import local_rows


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
    [B, H, W, C] on `device` from the explicit generator, drawn at the
    global batch (this rank's rows)."""
    src = generator.device if generator is not None else device
    shape = tuple(shape)
    return local_rows(lambda k: torch.randn(
        (k,) + shape[1:], generator=generator, device=src,
        dtype=torch.float32), shape[0]).to(device)


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


def swin_encoder_kwargs(cfg: Config, attn_impl: str,
                        generator: Optional[torch.Generator],
                        drop_path_rate: float, pe: bool = False) -> dict:
    """SwinTransformer's arguments for cfg's encoders. attn_impl="auto"
    follows cfg's four kernel flags, as gdl_tpu's classifiers read them:
    `use_pallas_attn=False` is attn_impl="plain" (which also takes the
    fused MLP's plain version), `use_pallas_attn_eval=False` the plain
    eval attention, `fuse_qkv_gemm=False` the projection outside the
    attention kernel and `fuse_mlp=True` the fused MLP; "plain" wins."""
    eval_impl = ("auto" if cfg.use_pallas_attn
                 and cfg.use_pallas_attn_eval else "plain")
    if attn_impl == "auto" and not cfg.use_pallas_attn:
        attn_impl = "plain"
    return dict(img_size=cfg.swin_img_size, patch_size=cfg.swin_patch,
                embed_dim=cfg.swin_embed_dim, depths=tuple(cfg.swin_depths),
                num_heads=tuple(cfg.swin_heads), window=cfg.swin_window,
                attn_impl=attn_impl, drop_path_rate=drop_path_rate,
                generator=generator, fuse_qkv=cfg.fuse_qkv_gemm,
                fuse_mlp=cfg.fuse_mlp, attn_eval_impl=eval_impl, pe=pe)


def swin_feature_dim(cfg: Config) -> int:
    """The channels of the Swin encoders' last map (1024 for Swin-B)."""
    return cfg.swin_embed_dim * 2 ** (len(cfg.swin_depths) - 1)


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

    attn_impl="plain" runs the plain PyTorch versions of the encoders'
    kernels on any device (the reference the CUDA kernels are held to);
    "auto" takes the kernels on the card, as cfg's four kernel flags say
    (`swin_encoder_kwargs`). drop_path_rate is the encoders' (0.1 in
    gdl_tpu). The DGL train step uses `encode`, `unimodal_logits` and
    `fused_logits`, gdl_tpu's protocol."""

    def __init__(self, cfg: Config, attn_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 drop_path_rate: float = 0.1):
        super().__init__()
        kw = swin_encoder_kwargs(cfg, attn_impl, generator, drop_path_rate)
        self.audio_net = SwinTransformer("audio", **kw)
        self.visual_net = SwinTransformer("visual", **kw)
        self.fusion_module = make_fusion(cfg.fusion_method, cfg.n_classes,
                                         dgl=True,
                                         input_dim=swin_feature_dim(cfg),
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


def modality_combo(batch: int, generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
    """The per-sample draw of the modality drop: a combination in {0, 1,
    2} for each of `batch` samples, from the explicit generator, drawn at
    the global batch (this rank's rows)."""
    src = generator.device if generator is not None else device
    return local_rows(lambda k: torch.randint(
        0, 3, (k,), generator=generator, device=src), batch).to(device)


def _modality_drop(a, v, generator: Optional[torch.Generator] = None):
    """Per-sample random modality masking over {audio only, visual only,
    both} (combination 0, 1, 2): the two-modality form of the
    reference's `modality_drop` augmentation (models/lib/model_arch.py:
    73-116), gated by `args.drop` (main.py:72)."""
    combo = modality_combo(a.shape[0], generator, a.device)
    keep_a = (combo != 1).to(a.dtype)[:, None]
    keep_v = (combo != 0).to(v.dtype)[:, None]
    return a * keep_a, v * keep_v


def _joint_tail(fusion_module, a, v, a_feature, v_feature, pe_outputs,
                drop: bool, generator: Optional[torch.Generator]):
    """Modality drop, the fused logits and the unimodal ones (the other
    modality zeroed, through the same head, on the same pooled
    features: the encoders run once) → the joint 11-tuple."""
    if drop:
        a, v = _modality_drop(a, v, generator)
    _, _, out = fusion_module(a, v)
    _, _, out_a = fusion_module(a, torch.zeros_like(v))
    _, _, out_v = fusion_module(torch.zeros_like(a), v)
    return (a, v, out, a_feature, v_feature, *pe_outputs, out_a, out_v)


class AVClassifier(nn.Module):
    """The joint-training classifier of the main.py lineage: dual
    ResNet-18 encoders and a baseline fusion head (gdl_tpu's
    reconstruction of the reference's missing class from its call
    sites). `forward(audio, visual, generator)` returns the 11-tuple

        (a, v, out, a_feature, v_feature, a_mul, a_std, v_mul, v_std,
         out_a, out_v)

    a / v the pooled features, out the fused logits, a_feature /
    v_feature the last maps (NHWC), mu / std the PE heads' outputs under
    cfg.pe and the int 0 without, out_a / out_v the head's logits with
    the other modality zeroed. In training mode, cfg.drop masks
    modalities per sample; `generator` feeds the PE noise, then the
    modality drop. pool_impl as for AVClassifierDGL."""

    def __init__(self, cfg: Config, pool_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pe, self.drop = bool(cfg.pe), bool(cfg.drop)
        kw = dict(width=cfg.encoder_width, stage_sizes=cfg.encoder_stages,
                  bn_groups=cfg.bn_groups, pool_impl=pool_impl,
                  generator=generator)
        self.audio_net = resnet18("audio", **kw)
        self.visual_net = resnet18("visual", **kw)
        self.fusion_module = make_fusion(
            cfg.fusion_method, cfg.n_classes, dgl=False,
            input_dim=cfg.encoder_dim, generator=generator)
        if self.pe:
            self.audio_pe = PEHead(cfg.encoder_dim, generator=generator)
            self.visual_pe = PEHead(cfg.encoder_dim, generator=generator)

    def forward(self, audio, visual,
                generator: Optional[torch.Generator] = None):
        a_feature = self.audio_net(audio)
        v_feature = self.visual_net(visual)
        if self.pe:
            a_map, a_mul, a_std = self.audio_pe(a_feature, generator)
            v_map, v_mul, v_std = self.visual_pe(v_feature, generator)
            pe_outputs = (a_mul, a_std, v_mul, v_std)
        else:
            a_map, v_map = a_feature, v_feature
            pe_outputs = (0, 0, 0, 0)
        a = _pool_audio(a_map)
        v = _pool_visual(v_map, audio.shape[0])
        return _joint_tail(self.fusion_module, a, v, a_feature, v_feature,
                           pe_outputs, self.drop and self.training,
                           generator)


class AVClassifierSwin(nn.Module):
    """The Swin-backbone joint classifier (gdl_tpu's reconstruction of
    the reference's missing `AVClassifier_SWIN`): two Swin encoders, a
    ConcatFusionSwin head sized to the real feature dimension (2 × 1024
    for Swin-B), the 11-tuple of AVClassifier. Under cfg.pe each encoder
    ends in a PE head and returns (pooled PE map, mu, std); the visual
    one is averaged over frames, and mu stands in for the maps.
    attn_impl and drop_path_rate as for AVClassifierSwinDGL; `generator`
    feeds DropPath and the PE noise of each encoder in turn, then the
    modality drop."""

    def __init__(self, cfg: Config, attn_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 drop_path_rate: float = 0.1):
        super().__init__()
        self.pe, self.drop = bool(cfg.pe), bool(cfg.drop)
        kw = swin_encoder_kwargs(cfg, attn_impl, generator, drop_path_rate,
                                 pe=self.pe)
        self.audio_net = SwinTransformer("audio", **kw)
        self.visual_net = SwinTransformer("visual", **kw)
        self.fusion_module = ConcatFusionSwin(2 * swin_feature_dim(cfg),
                                              cfg.n_classes, generator)

    def forward(self, audio, visual,
                generator: Optional[torch.Generator] = None):
        b = audio.shape[0]
        if self.pe:
            a, a_mul, a_std = self.audio_net(audio, generator)
            v_pooled, v_mul, v_std = self.visual_net(visual, generator)
            a_feature, v_feature = a_mul, v_mul
            v = v_pooled.reshape(b, v_pooled.shape[0] // b, -1).mean(dim=1)
            pe_outputs = (a_mul, a_std, v_mul, v_std)
        else:
            a_feature = self.audio_net(audio, generator)
            v_feature = self.visual_net(visual, generator)
            a = _pool_audio(a_feature)
            v = _pool_visual(v_feature, b)
            pe_outputs = (0, 0, 0, 0)
        return _joint_tail(self.fusion_module, a, v, a_feature, v_feature,
                           pe_outputs, self.drop and self.training,
                           generator)


class JointLogits(nn.Module):
    """A joint classifier seen through the eval contract of the port's
    loop and server, `(audio, visual) → (out, out_a, out_v)`: the fused
    logits thrice, as the reference's valid() overwrites out_a / out_v
    with out (main.py:459-460)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, audio, visual,
                generator: Optional[torch.Generator] = None):
        out = self.model(audio, visual, generator)[2]
        return out, out, out
