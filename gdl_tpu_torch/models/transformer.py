"""Transformer primitives of the mmformer family, port of
`gdl_tpu/models/transformer.py`: tanh-approximated GELU, SelfAttention
(qkv without bias, scaled dot product, proj), pre-norm residual blocks,
TransformerModel (returns every intermediate output), MMTransformerModel
(depth × [attn, ffn] over the concatenated token stream), the positional
encodings, and the modality-dropout augmentations.

Module attribute names are gdl_tpu's flax names (`norm1`, `attn.qkv`,
`attn.proj`, `norm2`, `ffn.fc1`, `ffn.fc2`, `block{i}`, `cross{j}`), so
`utils/interop.state_dict_from_flax` loads with strict=True.

Randomness is explicit: every stochastic module takes the
`torch.Generator` in `forward`, and every call site draws its own seed
words from it. The four dropout sites of a block (`Drop`) multiply by a
mask from the Philox generator of `ops/dropout.py` (kernel #14 on the
card); the attention-probability dropout runs inside the fused
self-attention op (`ops/self_attention.py`, kernels #10 and #11), which
draws its mask in the kernel (`SA_DROPOUT_IMPL = "kernel"`, gdl_tpu's
default) or reads one from memory ("hbm"). In eval mode SelfAttention
takes the forward-only op (kernel #13). Under CUDA autocast the fused
op's operands are cast to the autocast dtype, as nn.Linear's would be.

`SA_FUSED_QKV` (True | False, gdl_tpu's name and default, read when
SelfAttention runs): False takes, in training, the qkv projection out of
the fused op, as gdl_tpu does: `self.qkv(x)` (nn.Linear without bias,
cast by autocast like gdl_tpu's `jnp.dot`), then `self_attention_qkv` on
it (kernels #12 and #11). The parameters are the same under both values
(gdl_tpu's `_SaQkvParams` "qkv" is the projection either way), so
`utils/interop.py` maps them alike. The eval branch does not read it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gdl_tpu_torch.models.layers import lecun_normal_
from gdl_tpu_torch.ops.dropout import dropout as _dropout
from gdl_tpu_torch.ops.dropout import fold_seed_words
from gdl_tpu_torch.ops.self_attention import (
    sa_kernel_supported,
    self_attention_fused,
    self_attention_fused_eval,
    self_attention_qkv,
)

# attention-probability dropout inside the fused op: "kernel" (drawn in
# the forward and again in the backward) or "hbm" (a mask in memory)
SA_DROPOUT_IMPL = "kernel"
# the qkv projection inside the fused training op (True) or before it, as
# nn.Linear, with the attention on its output (False)
SA_FUSED_QKV = True

MODALITY_COMBINATIONS = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1],
     [1, 1, 1]], np.float32)


def dense(in_dim: int, out_dim: int, bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear with flax nn.Dense's default init (lecun-normal weight,
    zero bias)."""
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    lecun_normal_(layer.weight, in_dim, generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


class Drop(nn.Module):
    """Dropout of the transformer's four sites: identity in eval mode or
    at rate 0, else x · mask with a fresh mask from `generator`."""

    def __init__(self, rate: float, impl: str = "auto"):
        super().__init__()
        self.rate = rate
        self.impl = impl

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        return _dropout(x, self.rate, generator, self.impl)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The reference's hand-written tanh GELU (Transformer.py:9-14)."""
    return F.gelu(x, approximate="tanh")


class SelfAttention(nn.Module):
    """Transformer.py:17-51: qkv (no bias), scaled dot-product, proj.

    Where `sa_kernel_supported(dim, heads)` holds, projection, softmax,
    attention-probability dropout and p·v are the fused op: the training
    op in training mode (or whenever autograd needs a backward; under
    SA_FUSED_QKV = False `self.qkv` and then `self_attention_qkv`), the
    forward-only op otherwise. Other head configurations take the
    unfused path below, as in gdl_tpu. impl: "auto" launches the kernels
    on the card; "plain" runs their plain versions (and the plain mask
    generator) on any device."""

    def __init__(self, dim: int, heads: int = 8, dropout_rate: float = 0.0,
                 impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.heads, self.dropout_rate = dim, heads, dropout_rate
        self.impl = impl
        self.qkv = dense(dim, 3 * dim, bias=False, generator=generator)
        self.proj = dense(dim, dim, generator=generator)
        self.attn_drop = Drop(dropout_rate, impl)
        self.out_drop = Drop(dropout_rate, impl)

    @staticmethod
    def _autocast(x, w):
        """x and w in the autocast dtype, as nn.Linear would take them."""
        if torch.is_autocast_enabled(x.device.type):
            dt = torch.get_autocast_dtype(x.device.type)
            return x.to(dt), w.to(dt)
        return x, w

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, n, c = x.shape
        head_dim = self.dim // self.heads
        scale = head_dim ** -0.5
        if sa_kernel_supported(self.dim, self.heads):
            w = self.qkv.weight
            needs_grad = torch.is_grad_enabled() and (x.requires_grad
                                                      or w.requires_grad)
            if self.training or needs_grad:
                dropping = self.training and self.dropout_rate > 0.0
                words = (fold_seed_words(generator, x.device)
                         if dropping else None)
                kw = dict(dropout_rate=self.dropout_rate, seed_words=words,
                          train=self.training, dropout_impl=SA_DROPOUT_IMPL,
                          impl=self.impl)
                if SA_FUSED_QKV:
                    x, w = self._autocast(x, w)
                    out = self_attention_fused(x.contiguous(), w.contiguous(),
                                               self.heads, scale, **kw)
                else:
                    out = self_attention_qkv(self.qkv(x).contiguous(),
                                             self.heads, scale, **kw)
            else:
                x, w = self._autocast(x, w)
                out = self_attention_fused_eval(
                    x.contiguous(), w.contiguous(), self.heads, scale,
                    impl=self.impl)
        else:
            qkv = self.qkv(x).reshape(b, n, 3, self.heads, head_dim)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            attn = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
            attn = torch.softmax(attn * scale, dim=-1).to(v.dtype)
            attn = self.attn_drop(attn, generator)
            out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
            out = out.permute(0, 2, 1, 3).reshape(b, n, c)
        return self.out_drop(self.proj(out), generator)


class FeedForward(nn.Module):
    """Transformer.py:83-96."""

    def __init__(self, dim: int, hidden_dim: int, dropout_rate: float = 0.0,
                 impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = dense(dim, hidden_dim, generator=generator)
        self.fc2 = dense(hidden_dim, dim, generator=generator)
        self.drop1 = Drop(dropout_rate, impl)
        self.drop2 = Drop(dropout_rate, impl)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.drop1(gelu_tanh(self.fc1(x)), generator)
        return self.drop2(self.fc2(x), generator)


class TransformerBlock(nn.Module):
    """Residual(PreNormDrop(attn)) + Residual(PreNorm(ffn))
    (Transformer.py:54-96 composition)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.1,
                 impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SelfAttention(dim, heads, attn_dropout_rate, impl,
                                  generator)
        self.drop = Drop(dropout_rate, impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FeedForward(dim, mlp_dim, dropout_rate, impl, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.attn(self.norm1(x), generator)
        x = x + self.drop(y, generator)
        return x + self.ffn(self.norm2(x), generator)


class TransformerModel(nn.Module):
    """Transformer.py:99-130: depth blocks; returns
    (final, tuple_of_intermediates)."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.1,
                 impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", TransformerBlock(
                dim, heads, mlp_dim, dropout_rate, attn_dropout_rate, impl,
                generator))

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, tuple]:
        intermediates = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, generator)
            intermediates.append(x)
        return x, tuple(intermediates)


class MMTransformerModel(nn.Module):
    """mmTransformerModel (Transformer.py:133-206): depth × [attn, ffn]
    over the concatenated token stream."""

    def __init__(self, modal_num: int, dim: int, depth: int = 1,
                 heads: int = 8, mlp_dim: int = 4096,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.1,
                 impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.modal_num, self.depth = modal_num, depth
        for j in range(depth):
            setattr(self, f"cross{j}", TransformerBlock(
                dim, heads, mlp_dim, dropout_rate, attn_dropout_rate, impl,
                generator))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for j in range(self.depth):
            x = getattr(self, f"cross{j}")(x, generator)
        return x


class LearnedPositionalEncoding(nn.Module):
    """Zero-init additive position parameter (PositionalEncoding.py:24-36)."""

    def __init__(self, seq_length: int, embedding_dim: int):
        super().__init__()
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, seq_length, embedding_dim))

    def forward(self, x):
        return x + self.position_embeddings.to(x.dtype)


def fixed_positional_encoding(seq_length: int, dim: int) -> np.ndarray:
    """Sinusoidal table (PositionalEncoding.py:4-21)."""
    pe = np.zeros((seq_length, dim), np.float32)
    position = np.arange(seq_length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def _apply_modality_mask(xs: Sequence[torch.Tensor], mask: torch.Tensor):
    out = []
    for i, x in enumerate(xs):
        m = mask[:, i].reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        out.append(x * m.to(x.dtype))
    return out, mask


def modality_drop(xs: Sequence[torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  p: Optional[Sequence[float]] = None):
    """Per-sample uniform modality masking over the 7 non-empty 3-modality
    combinations (model_arch.py:73-116). xs: three [B, ...] feature maps;
    p: a fixed combination (e.g. [1, 0, 1]) to apply batch-wide instead of
    sampling. Returns (masked_xs, mask [B, 3])."""
    b, dev = xs[0].shape[0], xs[0].device
    combos = torch.from_numpy(MODALITY_COMBINATIONS).to(dev)
    if p is not None and any(p):
        mask = torch.tensor(list(p), dtype=torch.float32,
                            device=dev)[None].repeat(b, 1)
    else:
        src = generator.device if generator is not None else dev
        idx = torch.randint(0, 7, (b,), generator=generator, device=src)
        mask = combos[idx.to(dev)]
    return _apply_modality_mask(xs, mask)


def unbalance_modality_drop(xs: Sequence[torch.Tensor],
                            generator: Optional[torch.Generator] = None,
                            epoch: int = 0,
                            p: Optional[Sequence[float]] = None):
    """Curriculum-weighted masking (model_arch.py:120-202): before epoch 15
    the 7 combinations fill the batch evenly; after, the hard
    single-modality combos gain min(epoch-15, 7) slots each at the expense
    of the easy ones; the rows are then shuffled. Any batch size."""
    b, dev = xs[0].shape[0], xs[0].device
    if p is not None and any(p):
        return modality_drop(xs, generator, p)
    counts = np.full(7, b // 7, np.int32)
    counts[:b % 7] += 1
    if epoch >= 15:
        delta = min(epoch - 15, 7)
        for i in (0, 2, 4):
            counts[i] += delta
        for i in (3, 5, 6):
            counts[i] -= delta
        counts = np.clip(counts, 0, None)
        counts[1] += b - counts.sum()  # keep the total == batch
    rows = np.repeat(np.arange(7), counts)[:b]
    mask = torch.from_numpy(MODALITY_COMBINATIONS[rows]).to(dev)
    src = generator.device if generator is not None else dev
    perm = torch.randperm(b, generator=generator, device=src).to(dev)
    return _apply_modality_mask(xs, mask[perm])
