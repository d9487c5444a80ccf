"""Swin Transformer encoder, port of `gdl_tpu/models/swin.py`.

Submodules carry the reference's Microsoft names (`patch_embed.{proj,
norm}`, `layers.S.blocks.B.{norm1, attn.{qkv, proj,
relative_position_bias_table}, norm2, mlp.{fc1, fc2}}`,
`layers.S.downsample.{norm, reduction}`, `norm`), so a reference `.pth`
loads as it is. LayerNorm eps is 1e-5 and GELU is exact. With `pe`
the encoder ends in a PE head, `pe_head` (the joint lineage's `--pe 1`,
gdl_tpu/models/swin.py:551-558). In training mode (`model.train()`)
each block's two residual branches go through DropPath, at rates rising
linearly from 0 to `drop_path_rate` (0.1) over the blocks, with draws
from the `generator` passed to `forward`. DropPath has no parameters, so
the state dict is the same in both modes.

Inputs are channel-last as in the reference package: audio
[B, H, W, 1], visual [B, T, H, W, 3] (time folded into the batch). The
output is the [N, h, w, C] feature map of the last stage; with `pe`,
(its PE sample averaged over h and w, mu, std).

Window attention goes through `window_attention_qkv_fused` in training
mode (kernels #2 and #4 on the card) and `window_attention_qkv_fused_eval`
otherwise (kernel #1), as gdl_tpu's `train` flag selects its Pallas
entries; their plain versions run on the CPU or when the model is built
with attn_impl="plain". The spatial token layout is kept (gdl_tpu's
window-resident layout is the same math). Under CUDA autocast the
attention operands are cast to the autocast dtype, as nn.Linear's would
be, so a bf16 run takes the kernel's bf16 path.

Two switches follow gdl_tpu's flags of the same names; neither changes a
parameter's name, shape or initial value:

- `fuse_qkv=False` (`--fuse_qkv_gemm 0`): in training mode the qkv
  projection is the `nn.Linear` itself and `window_attention_qkv` takes
  its output (kernel #5, then #4). At eval gdl_tpu's forward-only kernel
  needs the fused projection, so the plain eval version runs.
- `fuse_mlp=True` (`--fuse_mlp 1`): each block's MLP is `mlp_fused`
  (kernel #15) where `mlp_kernel_supported`, else the `nn.Linear` chain.
- `attn_eval_impl` ("auto" | "plain"; `--use_pallas_attn_eval 0` gives
  "plain") is the eval attention's impl; attn_impl="plain" implies it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gdl_tpu_torch.ops.mlp import mlp_fused, mlp_kernel_supported, mlp_ref
from gdl_tpu_torch.ops.window_attention import (
    window_attention_qkv,
    window_attention_qkv_fused,
    window_attention_qkv_fused_eval,
)
from gdl_tpu_torch.parallel.distributed import local_rows
from gdl_tpu_torch.parallel.row_parallel import (
    RowParallelLinear,
    gather_columns,
)


@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> np.ndarray:
    """[N, N] indices into the (2w-1)² bias table (standard Swin recipe)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))  # [2, w, w]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """[nW, N, N] additive mask (0 / -100) for shifted windows."""
    img = np.zeros((h, w))
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, window², C] (contiguous)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int):
    """[B·nW, window², C] → [B, H, W, C]."""
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _trunc_normal(t: torch.Tensor, gen: torch.Generator) -> None:
    # the reference's _init_weights: timm trunc_normal_(std=.02)
    nn.init.trunc_normal_(t, std=0.02, generator=gen)


def _autocast_operands(x, *params):
    """x and the parameters in the autocast dtype where autocast is on (as
    nn.Linear's operands would be), contiguous."""
    if torch.is_autocast_enabled(x.device.type):
        dt = torch.get_autocast_dtype(x.device.type)
        x, params = x.to(dt), tuple(p.to(dt) for p in params)
    return (x.contiguous(), *(p.contiguous() for p in params))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int,
                 attn_impl: str = "auto", fuse_qkv: bool = True,
                 attn_eval_impl: str = "auto"):
        super().__init__()
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.attn_impl = attn_impl
        self.fuse_qkv = fuse_qkv
        self.attn_eval_impl = attn_eval_impl
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(
            "relative_position_index",
            torch.tensor(relative_position_index(window)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        n = x.shape[1]
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        bias = bias.reshape(n, n, self.num_heads).permute(2, 0, 1)
        bias = bias.float().contiguous()
        if self.training and not self.fuse_qkv:
            # the projection outside the kernel, as gdl_tpu's fuse_qkv=False
            out = window_attention_qkv(self.qkv(x).contiguous(), bias, mask,
                                       self.num_heads, impl=self.attn_impl)
            return self.proj(out)
        x, w, b = _autocast_operands(x, self.qkv.weight, self.qkv.bias)
        if self.training:
            out = window_attention_qkv_fused(x, w, b, bias, mask,
                                             self.num_heads,
                                             impl=self.attn_impl)
        else:
            plain = (self.attn_impl == "plain" or not self.fuse_qkv
                     or self.attn_eval_impl == "plain")
            out = window_attention_qkv_fused_eval(
                x, w, b, bias, mask, self.num_heads,
                impl="plain" if plain else self.attn_eval_impl)
        # the output projection stays outside the kernel, as in gdl_tpu
        return self.proj(out)


class DropPath(nn.Module):
    """Stochastic depth: in training mode each sample's branch is kept
    with probability 1 - rate and then scaled by 1/(1 - rate), or zeroed
    (gdl_tpu/models/swin.py::DropPath). The identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        tail = (1,) * (x.ndim - 1)
        # drawn at the global batch, this rank's rows
        mask = local_rows(lambda k: torch.rand((k,) + tail,
                                               generator=generator,
                                               device=x.device),
                          x.shape[0]) < keep
        return torch.where(mask, x / keep, 0.0)


class Mlp(nn.Module):
    """fc1 → exact GELU → fc2. With fuse_mlp the chain is `mlp_fused` on
    the flattened tokens where `mlp_kernel_supported` (kernel #15 on the
    card; `mlp_ref`, the same chain in plain ops, under impl="plain");
    the parameters are fc1's and fc2's either way. Under `--mp` fc2 is
    row-parallel (gdl_tpu's `mlp_fc2`): the chain of plain ops runs its
    split product, and #15, like the Pallas call GSPMD hands the whole
    operand, takes fc2's weight all-gathered (`gather_columns`)."""

    def __init__(self, dim: int, hidden: int, fuse_mlp: bool = False,
                 impl: str = "auto"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.fuse_mlp = fuse_mlp
        self.impl = impl

    def forward(self, x):
        c, hidden = x.shape[-1], self.fc1.out_features
        m = x.numel() // c
        dt = (torch.get_autocast_dtype(x.device.type)
              if torch.is_autocast_enabled(x.device.type) else x.dtype)
        if self.fuse_mlp and mlp_kernel_supported(m, c, hidden, dt):
            w2 = self.fc2.weight
            if isinstance(self.fc2, RowParallelLinear):  # --mp: whole
                w2 = gather_columns(w2)
            args = _autocast_operands(x.reshape(m, c), self.fc1.weight,
                                      self.fc1.bias, w2, self.fc2.bias)
            op = mlp_ref if self.impl == "plain" else mlp_fused
            return op(*args).reshape(x.shape)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    """One Swin block on [B, H·W, C] tokens; the cyclic shift is
    torch.roll, as in the reference."""

    def __init__(self, dim: int, resolution: Tuple[int, int], num_heads: int,
                 window: int, shift: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "auto", drop_path: float = 0.0,
                 fuse_qkv: bool = True, fuse_mlp: bool = False,
                 attn_eval_impl: str = "auto"):
        super().__init__()
        self.window = min(window, *resolution)
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, self.window, num_heads, attn_impl,
                                    fuse_qkv, attn_eval_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), fuse_mlp, attn_impl)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, h: int, w: int, shift: int, device) -> torch.Tensor:
        key = (h, w, shift, device)
        if key not in self._masks:
            self._masks[key] = torch.tensor(
                shift_attn_mask(h, w, self.window, shift), device=device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, h: int, w: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        win = self.window
        shift = self.shift if win < min(h, w) else 0
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self._mask(h, w, shift, x.device)
        y = self.attn(window_partition(y, win), mask)
        y = window_reverse(y, win, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path1(y.reshape(b, l, c), generator)
        return x + self.drop_path2(self.mlp(self.norm2(x)), generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, patch_size: int = 4,
                 embed_dim: int = 128):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)  # NCHW
        h, w = x.shape[2:]
        return self.norm(x.flatten(2).transpose(1, 2)), (h, w)


class BasicLayer(nn.Module):
    """One stage: `blocks`, then `downsample` (all stages but the last)."""

    def __init__(self, dim: int, resolution: Tuple[int, int], depth: int,
                 num_heads: int, window: int, mlp_ratio: float,
                 downsample: bool, attn_impl: str,
                 drop_paths: Sequence[float], fuse_qkv: bool = True,
                 fuse_mlp: bool = False, attn_eval_impl: str = "auto"):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, resolution, num_heads, window,
                      0 if i % 2 == 0 else window // 2, mlp_ratio, attn_impl,
                      drop_paths[i], fuse_qkv, fuse_mlp, attn_eval_impl)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """Swin feature encoder; `forward` returns the [N, h, w, C] map, or
    with pe=True the PE head's (mean over h, w of its sample, mu, std)."""

    def __init__(self, modality: str, img_size: int = 224,
                 patch_size: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 7,
                 mlp_ratio: float = 4.0, attn_impl: str = "auto",
                 drop_path_rate: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 fuse_qkv: bool = True, fuse_mlp: bool = False,
                 attn_eval_impl: str = "auto", pe: bool = False):
        super().__init__()
        self.modality = modality
        in_chans = 1 if modality == "audio" else 3
        self.patch_embed = PatchEmbed(in_chans, patch_size, embed_dim)
        res = img_size // patch_size
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        layers = []
        for s, depth in enumerate(depths):
            r = res // 2 ** s
            first = sum(depths[:s])
            layers.append(BasicLayer(
                embed_dim * 2 ** s, (r, r), depth, num_heads[s], window,
                mlp_ratio, s < len(depths) - 1, attn_impl,
                dpr[first:first + depth], fuse_qkv, fuse_mlp,
                attn_eval_impl))
        self.layers = nn.ModuleList(layers)
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.num_features, eps=1e-5)
        self.reset_parameters(generator)
        if pe:  # made after the reset: it keeps flax's conv init
            from gdl_tpu_torch.models.classifier import PEHead

            self.pe_head = PEHead(self.num_features, generator=generator)
        else:
            self.pe_head = None

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        """trunc-normal(0.02) dense and conv kernels and bias tables, zero
        biases, LayerNorm (1, 0); the PE head is not touched."""
        pe_head = getattr(self, "pe_head", None)
        skip = set(pe_head.modules()) if pe_head is not None else set()
        for m in self.modules():
            if m in skip:
                continue
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _trunc_normal(m.weight, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                _trunc_normal(m.relative_position_bias_table, gen)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` feeds the DropPath draws in training mode (None:
        torch's default generator of x's device)."""
        if self.modality == "visual":
            b, t, h, w, c = x.shape
            x = x.reshape(b * t, h, w, c)
        x, (h, w) = self.patch_embed(x.permute(0, 3, 1, 2))
        for layer in self.layers:
            for blk in layer.blocks:
                x = blk(x, h, w, generator)
            if layer.downsample is not None:
                x = layer.downsample(x, h, w)
                h, w = h // 2, w // 2
        x = self.norm(x)
        feat_map = x.reshape(x.shape[0], h, w, -1)
        if self.pe_head is None:
            return feat_map
        out_map, mu, std = self.pe_head(feat_map, generator)
        return out_map.mean(dim=(1, 2)), mu, std
