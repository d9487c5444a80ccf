"""Fusion heads, port of `gdl_tpu/models/fusion.py`.

Each head's `forward(x, y)` returns the reference 3-tuple
`(x_out, y_out, fused_out)`. The baseline heads (SumFusion, ConcatFusion,
FiLM, GatedFusion, ConcatFusionSwin) serve the joint / OGM-GE lineage
and are plain modules. The DGL heads also expose the two streams the
DGL train step uses:

  - `unimodal(x, y, detach_params)`: the unimodal logits from LIVE
    features. With detach_params the head's parameters get no gradient
    (gdl_tpu's `stop_fusion_gradients`, the reference's erasure of the
    fusion grads after the unimodal backward, main_dgl.py:114-119).
  - `fuse(x, y)`: the fused logits, detached exactly where the reference
    calls `.detach()` (fusion_modules.py:27-29, :53-56, :159-166,
    :235-244), so the fused loss never reaches the encoders.

Net gradient topology per step: encoders ← α·(loss_a + loss_v) only;
fusion head ← loss_f only; in the gated head fc_x/fc_y get no gradient
at all (the fused path detaches after them) and stay at their initial
values, as does the concat head's unused `fc_auxi`.

Under `--mp` the heads' linears are row-parallel over the model group
(`parallel/row_parallel.py`, swapped in by the trainer's harness); the
detached unimodal stream calls the same split product.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gdl_tpu_torch.models.layers import xavier_linear
from gdl_tpu_torch.parallel.row_parallel import (
    RowParallelLinear,
    row_parallel_linear,
)


def _apply(layer: nn.Module, x: torch.Tensor, detach: bool = False):
    """layer(x), with the layer's parameters detached if asked; a
    row-parallel layer (`--mp`) stays row-parallel."""
    if not detach:
        return layer(x)
    w, b = layer.weight.detach(), layer.bias.detach()
    if isinstance(layer, RowParallelLinear):
        return row_parallel_linear(x, w, b)
    return F.linear(x, w, b)


class SumFusion(nn.Module):
    """fc_x(x) + fc_y(y) (fusion_modules.py:5-13)."""

    def __init__(self, input_dim: int = 512, output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_x = xavier_linear(input_dim, output_dim, generator)
        self.fc_y = xavier_linear(input_dim, output_dim, generator)

    def forward(self, x, y):
        return x, y, self.fc_x(x) + self.fc_y(y)


class ConcatFusion(nn.Module):
    """fc_out(cat(x, y)) (fusion_modules.py:33-42); with input_dim
    2 × 1024 it is ConcatFusionSwin."""

    def __init__(self, input_dim: int = 1024, output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_out = xavier_linear(input_dim, output_dim, generator)

    def forward(self, x, y):
        return x, y, self.fc_out(torch.cat([x, y], dim=-1))


class ConcatFusionSwin(ConcatFusion):
    """The concat head of the Swin joint classifier
    (fusion_modules.py:79-88), sized by its caller to the real feature
    dimension (2 × 1024 for Swin-B; the reference's 768 × 2 does not fit
    Swin-B's features)."""

    def __init__(self, input_dim: int = 768 * 2, output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, output_dim, generator)


class FiLM(nn.Module):
    """Named FiLM, in fact a bilinear outer-product fusion
    (fusion_modules.py:91-124): fc_out(fc(x ⊗ y)). Returns the features
    unsqueezed, as the reference does (:116-117)."""

    def __init__(self, input_dim: int = 512, dim: int = 768,
                 output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = xavier_linear(input_dim * input_dim, dim, generator)
        self.fc_out = xavier_linear(dim, output_dim, generator)

    def forward(self, x, y):
        xe, ye = x[:, :, None], y[:, None, :]
        return xe, ye, self.fc_out(self.fc((xe * ye).flatten(1)))


class GatedFusion(nn.Module):
    """A sigmoid gate from one modality scales the other
    (fusion_modules.py:181-210)."""

    def __init__(self, input_dim: int = 512, dim: int = 512,
                 output_dim: int = 100, x_gate: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.x_gate = x_gate
        self.fc_x = xavier_linear(input_dim, dim, generator)
        self.fc_y = xavier_linear(input_dim, dim, generator)
        self.fc_out = xavier_linear(dim, output_dim, generator)

    def forward(self, x, y):
        out_x, out_y = self.fc_x(x), self.fc_y(y)
        if self.x_gate:
            out = self.fc_out(torch.sigmoid(out_x) * out_y)
        else:
            out = self.fc_out(out_x * torch.sigmoid(out_y))
        return out_x, out_y, out


class _FusionDGL(nn.Module):
    def forward(self, x, y):
        x_out, y_out = self.unimodal(x, y)
        return x_out, y_out, self.fuse(x, y)


class SumFusionDGL(_FusionDGL):
    """fusion_modules.py:16-30: unimodal logits fc_x(x), fc_y(y); fused
    logits their sum over detached features."""

    def __init__(self, input_dim: int = 512, output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_x = xavier_linear(input_dim, output_dim, generator)
        self.fc_y = xavier_linear(input_dim, output_dim, generator)

    def unimodal(self, x, y, detach_params: bool = False):
        return (_apply(self.fc_x, x, detach_params),
                _apply(self.fc_y, y, detach_params))

    def fuse(self, x, y):
        return self.fc_x(x.detach()) + self.fc_y(y.detach())


class ConcatFusionDGL(_FusionDGL):
    """The default DGL fusion (--fusion_method concat): unimodal logits
    come from the SAME fc_out fed zero-padded single-modality features,
    the fused logits from the concatenated features. The reference's
    `fc_auxi` is never used; it is kept so that state dicts load
    strictly."""

    def __init__(self, input_dim: int = 1024, output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_out = xavier_linear(input_dim, output_dim, generator)
        self.fc_auxi = xavier_linear(input_dim, output_dim, generator)

    def unimodal(self, x, y, detach_params: bool = False):
        x_out = _apply(self.fc_out, torch.cat([x, torch.zeros_like(y)], -1),
                       detach_params)
        y_out = _apply(self.fc_out, torch.cat([torch.zeros_like(x), y], -1),
                       detach_params)
        return x_out, y_out

    def fuse(self, x, y):
        return self.fc_out(torch.cat([x, y], dim=-1).detach())


class ConcatFusionDGLUnimodal(_FusionDGL):
    """The separate-AUXI ablation (fusion_modules.py:62-76): unimodal
    logits through a head of their own, `fc_auxi`. Under the DGL step
    fc_auxi gets no gradient (the unimodal stream detaches the head's
    parameters, the fused path never reaches it): the encoders learn
    through a frozen random head, as in the reference."""

    def __init__(self, input_dim: int = 1024, output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_out = xavier_linear(input_dim, output_dim, generator)
        self.fc_auxi = xavier_linear(input_dim, output_dim, generator)

    def unimodal(self, x, y, detach_params: bool = False):
        x_out = _apply(self.fc_auxi, torch.cat([x, torch.zeros_like(y)], -1),
                       detach_params)
        y_out = _apply(self.fc_auxi, torch.cat([torch.zeros_like(x), y], -1),
                       detach_params)
        return x_out, y_out

    def fuse(self, x, y):
        return self.fc_out(torch.cat([x, y], dim=-1).detach())


class FiLMDGL(_FusionDGL):
    """fusion_modules.py:126-178; named FiLM, in fact a bilinear
    outer-product fusion. fused: outer product of detached features
    through the shared fc/fc_out (:159-166); unimodal: per-modality outer
    SELF-products through the same heads (:168-176)."""

    def __init__(self, input_dim: int = 512, dim: int = 512,
                 output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = xavier_linear(input_dim * input_dim, dim, generator)
        self.fc_out = xavier_linear(dim, output_dim, generator)

    def _head(self, z, detach: bool = False):
        return _apply(self.fc_out, _apply(self.fc, z.flatten(1), detach),
                      detach)

    def unimodal(self, x, y, detach_params: bool = False):
        z_x = torch.einsum("bd,be->bde", x, x)
        z_y = torch.einsum("bd,be->bde", y, y)
        return self._head(z_x, detach_params), self._head(z_y, detach_params)

    def fuse(self, x, y):
        return self._head(torch.einsum("bd,be->bde", x.detach(), y.detach()))


class GatedFusionDGL(_FusionDGL):
    """fusion_modules.py:213-250. The reference detaches AFTER fc_x/fc_y
    in the fused path (:235-244), so fc_x/fc_y receive gradients from
    neither stream. Unimodal logits are self-gated through the shared
    fc_out (:246-249)."""

    def __init__(self, input_dim: int = 512, dim: int = 512,
                 output_dim: int = 100, x_gate: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.x_gate = x_gate
        self.fc_x = xavier_linear(input_dim, dim, generator)
        self.fc_y = xavier_linear(input_dim, dim, generator)
        self.fc_out = xavier_linear(dim, output_dim, generator)

    def unimodal(self, x, y, detach_params: bool = False):
        out_x = _apply(self.fc_x, x, detach_params)
        out_y = _apply(self.fc_y, y, detach_params)
        return (_apply(self.fc_out, torch.sigmoid(out_x) * out_x,
                       detach_params),
                _apply(self.fc_out, torch.sigmoid(out_y) * out_y,
                       detach_params))

    def fuse(self, x, y):
        x_d = self.fc_x(x).detach()
        y_d = self.fc_y(y).detach()
        if self.x_gate:
            return self.fc_out(torch.sigmoid(x_d) * y_d)
        return self.fc_out(x_d * torch.sigmoid(y_d))


def make_fusion(method: str, n_classes: int, dgl: bool,
                input_dim: int = 512,
                generator: Optional[torch.Generator] = None,
                shared_auxi: bool = True) -> nn.Module:
    """Fusion selection mirroring gdl_tpu's make_fusion
    (models/basic_model.py:28-40): the DGL heads with dgl, the baseline
    heads of the joint lineage without. shared_auxi=False selects the
    concat-DGL head with a separate unimodal head."""
    if method == "sum":
        cls = SumFusionDGL if dgl else SumFusion
        return cls(input_dim, n_classes, generator)
    if method == "concat":
        if dgl:
            cls = ConcatFusionDGL if shared_auxi else ConcatFusionDGLUnimodal
        else:
            cls = ConcatFusion
        return cls(2 * input_dim, n_classes, generator)
    if method == "film":
        cls = FiLMDGL if dgl else FiLM
        return cls(input_dim, output_dim=n_classes, generator=generator)
    if method == "gated":
        cls = GatedFusionDGL if dgl else GatedFusion
        return cls(input_dim, output_dim=n_classes, generator=generator)
    raise NotImplementedError("Incorrect fusion method: {}!".format(method))
