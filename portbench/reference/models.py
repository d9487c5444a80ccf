"""The cells' models in plain PyTorch: the dual-encoder DGL classifier of
the reference repository (ICCV2025-GDL `models/basic_model.py`) over
ResNet-18 (He et al. 2016; torchvision's layout, the reference's
`models/backbone.py`) or Swin (Liu et al. 2021; Microsoft's
`swin_transformer.py`) encoders, and its concat fusion head
(`fusion_modules.py`).

The module names are the reference `.pth` schema's, so the harness
hands the same named weights to this model and to the program.
Encoders take NCHW images: audio [B, 1, F, T], visual frames
[B·T, 3, 224, 224] (time folded into the batch). DropPath in Swin's
blocks draws from the generator passed to `forward`, in block order,
the first branch before the second, one draw of [rows, 1, 1] each,
skipped where its rate is 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# ResNet-18
# ---------------------------------------------------------------------------


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + identity)


class ResNet(nn.Module):
    """Stem conv 7×7/2, BN, ReLU, max pool 3×3/2, four stages of basic
    blocks; returns the last feature map [N, 8w, h, w]."""

    def __init__(self, in_chans: int, width: int = 64,
                 stages: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chans, width, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        cin = width
        for s, depth in enumerate(stages):
            cout = width * 2 ** s
            blocks = [BasicBlock(cin if i == 0 else cout, cout,
                                 2 if (s > 0 and i == 0) else 1)
                      for i in range(depth)]
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            cin = cout
        self.n_stages = len(stages)
        self.out_dim = cin

    def forward(self, x, gen=None):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(self.n_stages):
            x = getattr(self, f"layer{s + 1}")(x)
        return x


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shifted_window_mask(h: int, w: int, ws: int, shift: int, device):
    """[nW, N, N]: -100 between tokens of different regions of the
    cyclically shifted map, 0 within one."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = window_partition(img, ws).squeeze(-1)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, ws: int, heads: int):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                      indexing="ij")).reshape(2, -1)
        rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
        rel = rel + (ws - 1)
        index = rel[..., 0] * (2 * ws - 1) + rel[..., 1]
        self.register_buffer("relative_position_index",
                             torch.as_tensor(index, dtype=torch.long),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask: Optional[torch.Tensor]):
        bw, n, c = x.shape
        qkv = self.qkv(x).reshape(bw, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [bw, H, n, d]
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(bw // nw, nw, self.heads, n, n) + mask[None, :,
                                                                    None]
            attn = attn.view(bw, self.heads, n, n)
        attn = attn.softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


def drop_path(x, rate: float, training: bool, gen):
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=gen,
                      device=x.device)
    return torch.where(draw < keep, x / keep, 0.0)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, res: int, heads: int, ws: int, shift: int,
                 rate: float):
        super().__init__()
        self.ws = min(ws, res)
        self.shift = shift if ws < res else 0
        self.rate = rate
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, self.ws, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, h: int, w: int, gen):
        b, l, c = x.shape
        y = self.norm1(x).view(b, h, w, c)
        mask = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = shifted_window_mask(h, w, self.ws, self.shift, x.device)
        y = self.attn(window_partition(y, self.ws), mask)
        y = window_reverse(y, self.ws, h, w)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + drop_path(y.reshape(b, l, c), self.rate, self.training, gen)
        return x + drop_path(self.mlp(self.norm2(x)), self.rate,
                             self.training, gen)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, h: int, w: int):
        b, _, c = x.shape
        x = x.view(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, patch)
        self.norm = nn.LayerNorm(dim)


class Stage(nn.Module):
    def __init__(self, dim, res, depth, heads, ws, rates, last):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, res, heads, ws, 0 if i % 2 == 0 else ws // 2,
                      rates[i]) for i in range(depth)])
        self.downsample = None if last else PatchMerging(dim)


class Swin(nn.Module):
    """Swin encoder; returns the last stage's normed map [N, C, h, w]."""

    def __init__(self, in_chans: int, img: int = 224, patch: int = 4,
                 dim: int = 128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
                 window: int = 7, drop_path_rate: float = 0.1):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chans, patch, dim)
        rates = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        res = img // patch
        self.layers = nn.ModuleList()
        for s, depth in enumerate(depths):
            first = sum(depths[:s])
            self.layers.append(Stage(dim * 2 ** s, res // 2 ** s, depth,
                                     heads[s], window,
                                     rates[first:first + depth],
                                     s == len(depths) - 1))
        self.out_dim = dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.out_dim)

    def forward(self, x, gen=None):
        x = self.patch_embed.proj(x)
        h, w = x.shape[2:]
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x, h, w, gen)
            if stage.downsample is not None:
                x = stage.downsample(x, h, w)
                h, w = h // 2, w // 2
        x = self.norm(x)
        return x.transpose(1, 2).reshape(x.shape[0], -1, h, w)


# ---------------------------------------------------------------------------
# The DGL classifier
# ---------------------------------------------------------------------------


class ConcatFusionDGL(nn.Module):
    """fc_out over [a, v]; unimodal logits are fc_out over [a, 0] and
    [0, v], i.e. each modality's half of the weight and the bias.
    `fc_auxi` is unused (kept for the schema)."""

    def __init__(self, dim: int, n_classes: int):
        super().__init__()
        self.fc_out = nn.Linear(2 * dim, n_classes)
        self.fc_auxi = nn.Linear(2 * dim, n_classes)


class DGLClassifier(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        m = config["widths"]
        if config["model"] == "resnet18_dgl":
            def enc(c):
                return ResNet(c, m["width"], m["stages"])
        else:
            def enc(c):
                return Swin(c, 224, m["patch"], m["embed_dim"], m["depths"],
                            m["heads"], m["window"], m["drop_path_rate"])
        self.audio_net = enc(1)
        self.visual_net = enc(3)
        self.dim = self.audio_net.out_dim
        self.fusion_module = ConcatFusionDGL(self.dim, config["n_classes"])

    def features(self, audio, visual, batch: int, gen=None):
        """Pooled (a [B, D], v [B, D]); the visual map averaged over the
        clip's frames and positions."""
        a = self.audio_net(audio, gen).mean(dim=(2, 3))
        vmap = self.visual_net(visual, gen)
        v = vmap.view(batch, -1, *vmap.shape[1:]).mean(dim=(1, 3, 4))
        return a, v

    def logits(self, a, v, detach_head: bool):
        """(out, out_a, out_v). DGL: the unimodal logits see the head's
        parameters detached and the fused logits the features detached."""
        w, b = self.fusion_module.fc_out.weight, self.fusion_module.fc_out.bias
        wd, bd = (w.detach(), b.detach()) if detach_head else (w, b)
        out_a = F.linear(a, wd[:, :self.dim], bd)
        out_v = F.linear(v, wd[:, self.dim:], bd)
        fused_in = torch.cat([a, v], dim=-1)
        if detach_head:
            fused_in = fused_in.detach()
        return F.linear(fused_in, w, b), out_a, out_v

    def forward(self, audio, visual, batch: int):
        a, v = self.features(audio, visual, batch)
        return self.logits(a, v, detach_head=False)
