"""Intermediate-fusion model family, port of
`gdl_tpu/models/intermediate.py`: MMTM, SE-fusion, and the mmformer pair
(SURF_Fomer, SURF_Fomer_N).

Image-like tensors are channel-last at the public functions, as in
gdl_tpu: audio spectrograms enter as [B, F, T, 1] and the AV adapter
(mmtm_net.py:381-387) turns them into a 3-channel 224² 'rgb' stream;
frames enter as [B, 1, H, W, 3]. Module attribute names are gdl_tpu's
flax names (`stem_rgb`, `project0`, `pe0`, `intra0.cross0`, `inter_pe`,
`inter`, `token_fuse`, ...), so `utils/interop.state_dict_from_flax`
loads with strict=True.

Randomness (dropout, PE noise, modality drop) comes from the
`torch.Generator` given to `forward`. `impl` is handed down to the
hand-written kernels of the family (fused self-attention, dropout
masks, the stem max-pool's backward): "auto" launches them on the card,
"plain" runs their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gdl_tpu_torch.models.classifier import PEHead, lecun_conv
from gdl_tpu_torch.models.layers import batch_norm, xavier_linear
from gdl_tpu_torch.models.resnet import BasicBlock
from gdl_tpu_torch.models.se_resnet import SEStem, SETrunk, to_nchw, to_nhwc
from gdl_tpu_torch.models.transformer import (
    LearnedPositionalEncoding,
    MMTransformerModel,
    modality_drop,
    unbalance_modality_drop,
)
from gdl_tpu_torch.ops.image_ops import _resample_weights

AV_DATASETS = ("AVE", "CREMAD", "KineticSound")


def av_adapt(spec: torch.Tensor, frames: torch.Tensor):
    """The audio-visual input adapter (mmtm_net.py:381-387): spectrogram
    [B, F, T, 1] → 3-channel 224² image; frames [B, 1, H, W, 3] → squeeze
    the single time step.

    gdl_tpu resizes with `jax.image.resize(..., "bilinear")`, which
    antialiases the axis it shrinks (257 → 224) and interpolates the one
    it stretches (188 → 224); the same weight matrices are applied here,
    in float32 whatever the autocast dtype."""
    b, f, t, _ = spec.shape
    dev = spec.device
    with torch.autocast(dev.type, enabled=False):
        one = torch.ones(1, device=dev)
        zero = torch.zeros(1, device=dev)
        wy = _resample_weights(f, 224, one * (224.0 / f), zero)[0]
        wx = _resample_weights(t, 224, one * (224.0 / t), zero)[0]
        # two pairwise products, in the order the three-operand einsum
        # takes them (the same bits), which leaves the batch symbolic
        # under torch.export: the three-operand path is chosen from sizes
        img = torch.einsum("bow,pw->bop", torch.einsum(
            "oh,bhw->bow", wy, spec[..., 0].float()), wx)
    rgb = img[..., None].expand(b, 224, 224, 3)
    return rgb, frames.squeeze(1)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """LeakyReLU with gdl_tpu's gradient at exactly 0, which is 1
    (`jnp.where(x >= 0, x, slope * x)`); F.leaky_relu's is `slope`. The
    zero-input token streams of MMFormerN sit exactly there while the
    projection BatchNorm's bias is at its zero init."""
    return torch.where(x >= 0, x, slope * x)


class MMTM(nn.Module):
    """Multimodal squeeze-excite recalibration (mmtm_net.py:236-276) of
    two NCHW maps."""

    def __init__(self, dim_a: int, dim_b: int, ratio: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dim_out = int(2 * (dim_a + dim_b) / ratio)
        self.fc_squeeze = xavier_linear(dim_a + dim_b, dim_out, generator)
        self.fc_a = xavier_linear(dim_out, dim_a, generator)
        self.fc_b = xavier_linear(dim_out, dim_b, generator)

    def forward(self, a, b):
        squeeze = torch.cat([a.mean(dim=(2, 3)), b.mean(dim=(2, 3))], dim=-1)
        e = F.relu(self.fc_squeeze(squeeze))
        ga = torch.sigmoid(self.fc_a(e)).to(a.dtype)
        gb = torch.sigmoid(self.fc_b(e)).to(b.dtype)
        return a * ga[:, :, None, None], b * gb[:, :, None, None]


class MMTMNet(nn.Module):
    """MMTM_Net (mmtm_net.py:318-407): two SE-less stems, MMTM gates at
    the layer2/3/4 boundaries, a trunk whose layer3/layer4 weights are
    shared between the two streams (mmtm_net.py:341-344), concat + fc
    head. Returns (out, out_rgb, out_depth), the unimodal logits zeroing
    the other stream through the same fusion path (:399-406)."""

    def __init__(self, num_classes: int, width: int = 64, impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        kw = dict(use_se=False, width=w, pool_impl=impl, generator=generator)
        self.stem_rgb = SEStem(**kw)
        self.stem_depth = SEStem(**kw)
        self.mmtm0 = MMTM(2 * w, 2 * w, 2, generator)
        self.mmtm1 = MMTM(4 * w, 4 * w, 2, generator)
        self.mmtm2 = MMTM(8 * w, 8 * w, 2, generator)
        self.layer3 = nn.Sequential(
            BasicBlock(2 * w, 4 * w, 2, generator=generator),
            BasicBlock(4 * w, 4 * w, 1, generator=generator))
        self.layer4 = nn.Sequential(
            BasicBlock(4 * w, 8 * w, 2, generator=generator),
            BasicBlock(8 * w, 8 * w, 1, generator=generator))
        self.fc = xavier_linear(16 * w, num_classes, generator)

    def fusion(self, x_rgb, x_depth):
        """The reference order (mmtm_net.py:355-377): mmtm0 → layer3 →
        mmtm1 → layer4 → mmtm2 → pool → concat. The shared blocks see the
        rgb stream first, then the depth stream, block by block."""
        x_rgb, x_depth = self.mmtm0(x_rgb, x_depth)
        for blk in self.layer3:
            x_rgb, x_depth = blk(x_rgb), blk(x_depth)
        x_rgb, x_depth = self.mmtm1(x_rgb, x_depth)
        for blk in self.layer4:
            x_rgb, x_depth = blk(x_rgb), blk(x_depth)
        x_rgb, x_depth = self.mmtm2(x_rgb, x_depth)
        return torch.cat([x_rgb.mean(dim=(2, 3)), x_depth.mean(dim=(2, 3))],
                         dim=-1)

    def forward(self, spec, frames,
                generator: Optional[torch.Generator] = None,
                av_inputs: bool = True):
        rgb, depth = av_adapt(spec, frames) if av_inputs else (spec, frames)
        x_rgb = to_nchw(self.stem_rgb(rgb))
        x_depth = to_nchw(self.stem_depth(depth))
        out = self.fc(self.fusion(x_rgb, x_depth))
        out_rgb = self.fc(self.fusion(x_rgb, torch.zeros_like(x_depth)))
        out_depth = self.fc(self.fusion(torch.zeros_like(x_rgb), x_depth))
        return out, out_rgb, out_depth


class SEFusionNet(nn.Module):
    """SURF_Multi (sefusion.py:20-63): two SE stems, channel concat,
    shared (layer3, layer4, pool, fc) trunk → logits."""

    def __init__(self, num_classes: int, width: int = 64, impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(use_se=True, width=width, pool_impl=impl,
                  generator=generator)
        self.stem_rgb = SEStem(**kw)
        self.stem_depth = SEStem(**kw)
        self.trunk = SETrunk(num_classes, width, 4 * width, generator)

    def forward(self, rgb, depth,
                generator: Optional[torch.Generator] = None,
                av_inputs: bool = False):
        if av_inputs:  # (spectrogram, frames) → two image streams
            rgb, depth = av_adapt(rgb, depth)
        x = torch.cat([self.stem_rgb(rgb), self.stem_depth(depth)], dim=-1)
        return self.trunk(x)


class _TokenProject(nn.Module):
    """BN + LeakyReLU + 3x3 conv to the embedding dim, then flatten to
    tokens (surf_mmfomer.py:99-102, :285-291). NHWC map →
    ([B, h·w, embed], (h, w))."""

    def __init__(self, in_channels: int, embed_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bn = batch_norm(in_channels)
        self.proj = lecun_conv(in_channels, embed_dim, 3, generator)

    def forward(self, x):
        x = self.proj(leaky_relu(self.bn(to_nchw(x)), 0.01))
        b, c, h, w = x.shape
        return to_nhwc(x).reshape(b, h * w, c), (h, w)


class MMFormer(nn.Module):
    """SURF_Fomer (surf_mmfomer.py:14-167): 3-modality mmformer: SE stems,
    modality-dropout augmentation, per-modality BN+LeakyReLU+conv
    tokenization, learned positional encoding + intra-modality
    transformer, conv restore, channel concat, shared SE trunk. Returns
    (logits, layer3, layer4). Made well-formed as in gdl_tpu (the 2x2 avg
    pool before tokenization; the trunk takes the 3·128 concat)."""

    def __init__(self, num_classes: int, embed_dim: int = 512,
                 width: int = 64, seq_len: int = 196,
                 drop_mode: str = "average", impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        self.embed_dim, self.drop_mode = embed_dim, drop_mode
        for i in range(3):
            setattr(self, f"stem{i}", SEStem(
                use_se=True, use_avg=True, width=w, pool_impl=impl,
                generator=generator))
            setattr(self, f"project{i}", _TokenProject(2 * w, embed_dim,
                                                       generator))
            setattr(self, f"pe{i}", LearnedPositionalEncoding(seq_len,
                                                              embed_dim))
            setattr(self, f"intra{i}", MMTransformerModel(
                modal_num=3, dim=embed_dim, depth=1, heads=8, mlp_dim=4096,
                impl=impl, generator=generator))
            setattr(self, f"restore{i}", lecun_conv(embed_dim, 2 * w, 3,
                                                    generator))
        self.trunk = SETrunk(num_classes, w, 6 * w, generator)

    def forward(self, rgb, ir, depth,
                generator: Optional[torch.Generator] = None, epoch: int = 0,
                drop_p: Optional[tuple] = None):
        xs = [getattr(self, f"stem{i}")(x)
              for i, x in enumerate((rgb, ir, depth))]
        if self.training:
            if self.drop_mode == "average":
                xs, _ = modality_drop(xs, generator, drop_p)
            else:
                xs, _ = unbalance_modality_drop(xs, generator, epoch, drop_p)
        outs = []
        for i in range(3):
            tokens, (h, w) = getattr(self, f"project{i}")(xs[i])
            tokens = getattr(self, f"pe{i}")(tokens)
            tokens = getattr(self, f"intra{i}")(tokens, generator)
            fmap = tokens.reshape(tokens.shape[0], h, w, self.embed_dim)
            outs.append(to_nhwc(getattr(self, f"restore{i}")(to_nchw(fmap))))
        return self.trunk(torch.cat(outs, dim=-1), return_maps=True)


class MMFormerN(nn.Module):
    """SURF_Fomer_N (surf_mmfomer.py:170-356): 2-modality variant: SE-less
    stems + 2x2 avg, PE heads, intra- then inter-modality transformers,
    Conv1d token fusion (392→196 tokens), pooled fc. Returns the
    reference 7-tuple (x_f, mu_rgb, std_rgb, mu_depth, std_depth, x_r,
    x_i), x_r/x_i zeroing the other stream through the shared fusion
    (surf_mmfomer.py:337-351).

    share_streams computes each modality's project → PE → intra token
    stream once per distinct input (live, zero) and reuses it across the
    fused and unimodal passes: 4 intra stacks instead of 6, each
    projection BatchNorm updated twice a step instead of three times, in
    gdl_tpu's call order. batched_inter runs the three passes' BN-free
    inter half as one [3B] call."""

    def __init__(self, num_classes: int, embed_dim: int = 512,
                 width: int = 64, seq_len: int = 196,
                 share_streams: bool = False, batched_inter: bool = False,
                 impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        self.share_streams, self.batched_inter = share_streams, batched_inter
        kw = dict(use_se=False, use_avg=True, width=w, pool_impl=impl,
                  generator=generator)
        self.stem_rgb = SEStem(**kw)
        self.stem_ir = SEStem(**kw)
        self.rgb_p = PEHead(2 * w, generator=generator)
        self.depth_p = PEHead(2 * w, generator=generator)
        for i in range(2):
            setattr(self, f"project{i}", _TokenProject(2 * w, embed_dim,
                                                       generator))
            setattr(self, f"pe{i}", LearnedPositionalEncoding(seq_len,
                                                              embed_dim))
            setattr(self, f"intra{i}", MMTransformerModel(
                modal_num=2, dim=embed_dim, depth=1, heads=8, mlp_dim=4096,
                impl=impl, generator=generator))
        self.inter_pe = LearnedPositionalEncoding(2 * seq_len, embed_dim)
        self.inter = MMTransformerModel(
            modal_num=2, dim=embed_dim, depth=1, heads=8, mlp_dim=4096,
            impl=impl, generator=generator)
        # Conv1d(392, 196, k1) over tokens == a dense mixing of the token
        # axis; kernel [392, 196] applied to [B, 392, C] on the token dim
        self.token_fuse = nn.Parameter(torch.empty(2 * seq_len, seq_len))
        with torch.no_grad():
            nn.init.normal_(self.token_fuse, std=(2.0 / (3 * seq_len)) ** 0.5,
                            generator=generator)  # xavier normal
        self.token_fuse_bias = nn.Parameter(torch.zeros(seq_len))
        self.fc = xavier_linear(embed_dim, num_classes, generator)

    def _intra_stream(self, i: int, x, generator):
        """project → positional encoding → intra transformer for one
        modality."""
        t, _ = getattr(self, f"project{i}")(x)
        t = getattr(self, f"pe{i}")(t)
        return getattr(self, f"intra{i}")(t, generator)

    def _inter_tail(self, x, generator, passes: int = 1):
        """PE → inter transformer → token fuse → pool on an already
        seq-concatenated [B', 2·seq_len, C] stream. BN-free and row-wise,
        so batching fusion passes along B' is exact; B' stacks `passes`
        passes' batches, which places each pass's dropout masks at that
        pass's rows of the global batch under a process group."""
        x = self.inter(self.inter_pe(x), generator, passes)
        x = torch.einsum("bnc,nm->bmc", x, self.token_fuse.to(x.dtype)) \
            + self.token_fuse_bias[None, :, None].to(x.dtype)
        return x.mean(dim=1)

    def fusion_function(self, x_rgb, x_ir,
                        generator: Optional[torch.Generator] = None):
        tokens = [self._intra_stream(0, x_rgb, generator),
                  self._intra_stream(1, x_ir, generator)]
        return self._inter_tail(torch.cat(tokens, dim=1), generator)

    def forward(self, spec, frames,
                generator: Optional[torch.Generator] = None,
                av_inputs: bool = True):
        rgb, ir = av_adapt(spec, frames) if av_inputs else (spec, frames)
        x_rgb = self.stem_rgb(rgb)
        x_ir = self.stem_ir(ir)
        x_rgb, mu_rgb, std_rgb = self.rgb_p(x_rgb, generator)
        x_ir, mu_depth, std_depth = self.depth_p(x_ir, generator)

        def stream(i, x):
            return self._intra_stream(i, x, generator)

        if self.share_streams:
            t_rgb = stream(0, x_rgb)
            t_ir = stream(1, x_ir)
            t_rgb0 = stream(0, torch.zeros_like(x_rgb))
            t_ir0 = stream(1, torch.zeros_like(x_ir))
            pairs = [(t_rgb, t_ir), (t_rgb, t_ir0), (t_rgb0, t_ir)]
        else:
            # the 6 BN-bearing intra calls keep the reference's per-module
            # input sequence (f, r, i passes in order), so the running
            # statistics compound identically
            pairs = [
                (stream(0, x_rgb), stream(1, x_ir)),
                (stream(0, x_rgb), stream(1, torch.zeros_like(x_ir))),
                (stream(0, torch.zeros_like(x_rgb)), stream(1, x_ir)),
            ]
        seqs = [torch.cat(p, dim=1) for p in pairs]
        if self.batched_inter:
            out = self.fc(self._inter_tail(torch.cat(seqs, dim=0), generator,
                                           passes=len(seqs)))
            x_f, x_r, x_i = out.chunk(3, dim=0)
        else:
            x_f, x_r, x_i = (self.fc(self._inter_tail(s, generator))
                             for s in seqs)
        return x_f, mu_rgb, std_rgb, mu_depth, std_depth, x_r, x_i


class TripleLogits(nn.Module):
    """An intermediate-family model seen through the eval contract of the
    port's loop and server: `(audio, visual) → (out, out_a, out_v)`.
    kind 'triple' passes MMTM's outputs through, 'seven' picks
    SURF_Fomer_N's x_f, x_r, x_i, 'single' repeats SE-fusion's logits
    (main_intermediate.py:199-212)."""

    def __init__(self, model: nn.Module, kind: str):
        super().__init__()
        if kind not in ("triple", "seven", "single"):
            raise ValueError(f"unknown output kind {kind!r}")
        self.model, self.kind = model, kind

    def forward(self, audio, visual,
                generator: Optional[torch.Generator] = None):
        out = self.model(audio, visual, generator, av_inputs=True)
        if self.kind == "triple":
            return out
        if self.kind == "seven":
            return out[0], out[5], out[6]
        return out, out, out


def build_intermediate(name: str, n_classes: int, width: int = 64,
                       share_streams: bool = False,
                       batched_inter: bool = False, impl: str = "auto",
                       generator: Optional[torch.Generator] = None,
                       **model_kwargs):
    """Model factory for the intermediate family → (model, kind), `kind`
    naming the eval-output contract: 'triple' = MMTM's (out, out_a,
    out_v), 'single' = SE-fusion's one logits array, 'seven' =
    SURF_Fomer_N's 7-tuple. Shared by `main_intermediate` and `serve`."""
    if name == "mmtm":
        return MMTMNet(n_classes, width, impl, generator,
                       **model_kwargs), "triple"
    if name == "sefusion":
        return SEFusionNet(n_classes, width, impl, generator,
                           **model_kwargs), "single"
    if name == "mmformer_n":
        return MMFormerN(n_classes, width=width, share_streams=share_streams,
                         batched_inter=batched_inter, impl=impl,
                         generator=generator, **model_kwargs), "seven"
    raise NotImplementedError("unknown intermediate model: " + name)
